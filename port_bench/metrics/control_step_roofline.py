"""control_step_roofline: the control-step kernel's bound (ceiling.py, by
operations, at the cell's envs and variant) times its launches in the
traced window, over the summed device time of its rows there
(``agt_control_step*`` kernels), in %.  Nothing where the trace holds no
such row; the launch count is held to steps_per_iter per iteration, by the
trace's rows."""

import sys

from port_bench import ceiling

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
        print(f"control_step_roofline: {len(rows)} kernel rows in the window, "
              f"expected {expected} ({ctx['steps']} an iteration)", file=sys.stderr)
        return None
    bound_ms, _ = ceiling.control_step_bound(ctx["model_counts"]["counts"], ctx["num_envs"],
                                             per_env=ctx["per_env"])
    return dict(value=100.0 * bound_ms * len(rows) / (sum(rows) / 1e6), unit="%")
