"""``control_step_ms`` on synthetic traced windows: the mean device time of
the window's control-step kernel rows in ms a launch, and nothing where
the trace holds none or not ``steps_per_iter`` an iteration."""

import pytest

from port_bench import run

# two iterations of 3 steps in a window from 1,000 to 100,000 ns
KERNELS = [("void agt_control_step_kernel<false, 48>(AgtModel, float const*, float*, int)",
            2_000 + 10_000 * k, 400_000 + 1_000 * k) for k in range(6)]
OTHERS = [("ampere_sgemm_128x64_nn", 5_000, 7_000_000),
          ("void agt_control_step_kernel<false, 48>(AgtModel, float const*, float*, int)",
           150_000, 900_000)]                    # after the window: not counted


def _ctx(device, steps=3, iterations=2, traced=True):
    ctx = dict(steps=steps, iterations=iterations)
    if traced:
        ctx["trace"] = dict(device=sorted(device, key=lambda r: r[1]), window=(1_000, 100_000))
    return ctx


def test_mean_launch_time_in_ms():
    got = run.read_metric("control_step_ms", _ctx(KERNELS + OTHERS))
    assert got["unit"] == "ms"
    assert got["value"] == pytest.approx(sum(d for _, _, d in KERNELS) / 6 / 1e6)
    assert got["value"] == pytest.approx(0.4025)


@pytest.mark.parametrize("case", ["untraced", "no_rows", "rows_short"])
def test_nothing_to_read(case, capsys):
    if case == "untraced":
        ctx = _ctx(KERNELS, traced=False)
    elif case == "no_rows":
        ctx = _ctx(OTHERS[:1])
    else:
        ctx = _ctx(KERNELS[:5])
    assert run.read_metric("control_step_ms", ctx) is None
    if case == "rows_short":
        assert "5 kernel rows in the window, expected 6" in capsys.readouterr().err
