"""The readers of the program's spans (``port_bench/spans.py`` and the six
metrics on it) on a synthetic traced window: host rows, device rows, the
program's spans and an anchor.  Each gives the value worked out by hand,
and nothing where the program records no spans, the trace holds no anchor,
the anchor maps too far, or a span count is not what the iterations make."""

import pytest

from port_bench import run, spans

ANCHOR = spans.ANCHOR
# one iteration of 2 control steps and 1 minibatch step (1 epoch, batch_size 2)
RECORDS = [
    (ANCHOR, 900, 1_100, "train_iter", 0),
    ("rollout.step", 1_300, 20_000, "rollout", 0),
    ("rollout.step", 20_000, 45_000, "rollout", 0),
    ("rollout", 1_200, 50_000, "train_iter", 0),
    ("update.minibatch", 51_000, 89_000, "update", 0),
    ("update", 50_000, 90_000, "train_iter", 0),
    ("train_iter", 1_100, 100_000, None, 0),
]
HOST = [(ANCHOR, 1_000, 0), ("cudaLaunchKernel", 1_400, 5), ("aten::mul", 1_450, 40),
        ("cudaLaunchKernel", 1_500, 5), ("cudaLaunchKernel", 19_000, 5),
        ("cudaMemcpyAsync", 21_000, 5), ("cudaLaunchKernel", 30_000, 5),
        ("cudaLaunchKernelExC", 60_000, 5), ("aten::add", 61_000, 40),
        ("cudaLaunchKernel", 95_000, 5)]
# busy 5-10 us, 25-52 us, 60-95 us of a 0-110 us window
DEVICE = [("k", 5_000, 5_000), ("k", 25_000, 27_000), ("k", 60_000, 35_000)]
EXPECTED = {
    "step_launches": 2.5,                      # 3 in the first step, 2 in the second
    "step_host_ms": (18_700 + 25_000) / 2 / 1e6,
    "minibatch_launches": 1.0,
    "minibatch_host_ms": 38_000 / 1e6,
    "rollout_wait_ms": (3_800 + 15_000) / 1e6,  # idle 1.2-5 us and 10-25 us
    "update_wait_ms": 8_000 / 1e6,              # idle 52-60 us
}


def _ctx(iterations=1, host=HOST):
    return dict(iterations=iterations, steps=2, cfg=dict(agent=dict(batch_size=2, update_epochs=1)),
                trace=dict(host=list(host), device=list(DEVICE), marks={}, window=(0, 110_000)))


@pytest.fixture
def records(monkeypatch):
    box = [list(RECORDS)]
    monkeypatch.setattr(spans, "_records", lambda: box[0])
    return box


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_value(records, metric, capsys):
    got = run.read_metric(metric, _ctx())
    assert got["value"] == pytest.approx(EXPECTED[metric], rel=1e-12)
    assert got["unit"] == ("launches" if metric.endswith("launches") else "ms")
    assert "idle by program span" in capsys.readouterr().err


def test_idle_by_span_names_the_innermost_span(records, capsys):
    run.read_metric("step_launches", _ctx())
    err = capsys.readouterr().err
    # gaps 0-5 (mid 2.5 us: the first step), 10-25 (mid 17.5: the first step),
    # 52-60 (mid 56: the minibatch), 95-110 (mid 102.5: no span)
    assert "rollout.step 0.000" in err and "update.minibatch 0.000" in err and "(none)" in err


@pytest.mark.parametrize("case", ["no_spans", "no_anchor", "far_anchor", "step_count",
                                  "minibatch_count", "iterations", "untraced"])
def test_reader_gives_nothing(records, case, capsys):
    ctx = _ctx()
    if case == "no_spans":
        records[0] = None
    elif case == "no_anchor":
        ctx = _ctx(host=[r for r in HOST if r[0] != ANCHOR])
    elif case == "far_anchor":
        records[0] = [(ANCHOR, 900 - 60_000, 1_100 - 60_000, "train_iter", 0)] + RECORDS[1:]
    elif case == "step_count":
        records[0] = [r for r in RECORDS if r[1] != 20_000]
    elif case == "minibatch_count":
        records[0] = [r for r in RECORDS if r[0] != "update.minibatch"]
    elif case == "iterations":
        ctx = _ctx(iterations=2)
    else:
        del ctx["trace"]
    for metric in EXPECTED:
        assert run.read_metric(metric, ctx) is None
    assert capsys.readouterr().err.count("\n") >= len(EXPECTED)
