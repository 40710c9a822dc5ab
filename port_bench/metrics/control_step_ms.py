"""control_step_ms: the mean device time of one control-step kernel launch
(``agt_control_step*`` rows) in the traced window, in ms.  Nothing where
the trace holds no such row; the launch count is held to steps_per_iter
per iteration, by the trace's rows, as ``control_step_roofline`` holds it."""

import sys

KERNEL = "agt_control_step"


def read(ctx):
    if "trace" not in ctx:
        return None
    w0, w1 = ctx["trace"]["window"]
    rows = [d for name, s, d in ctx["trace"]["device"] if KERNEL in name and w0 <= s < w1]
    if not rows:
        return None
    expected = ctx["steps"] * ctx["iterations"]
    if len(rows) != expected:
        print(f"control_step_ms: {len(rows)} kernel rows in the window, "
              f"expected {expected} ({ctx['steps']} an iteration)", file=sys.stderr)
        return None
    return dict(value=sum(rows) / len(rows) / 1e6, unit="ms")
