"""``step_graph_share`` on the synthetic traced window of
``test_pb_spans.py``: the share of control steps holding an ``env.graph``
span, and nothing where the program records no such span."""

import pytest

from port_bench import run, spans
from port_bench.tests.test_pb_spans import RECORDS, _ctx


@pytest.mark.parametrize("graphs,share", [
    ([("env.graph", 2_000, 15_000, "env.step", 0), ("env.graph", 21_000, 44_000, "env.step", 0)],
     100.0),
    ([("env.graph", 21_000, 44_000, "env.step", 0)], 50.0),
    # one outside every control step: not counted
    ([("env.graph", 21_000, 44_000, "env.step", 0), ("env.graph", 46_000, 49_000, "rollout", 0)],
     50.0),
])
def test_share_of_steps_with_a_graph(monkeypatch, graphs, share):
    monkeypatch.setattr(spans, "_records", lambda: graphs + RECORDS)
    got = run.read_metric("step_graph_share", _ctx())
    assert got == dict(value=share, unit="%")


def test_nothing_without_graph_spans(monkeypatch, capsys):
    monkeypatch.setattr(spans, "_records", lambda: list(RECORDS))
    assert run.read_metric("step_graph_share", _ctx()) is None
    assert "no env.graph span" in capsys.readouterr().err
    monkeypatch.setattr(spans, "_records", lambda: None)
    assert run.read_metric("step_graph_share", _ctx()) is None
