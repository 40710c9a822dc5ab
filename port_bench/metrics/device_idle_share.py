"""device_idle_share: one minus the union of the device ops' intervals
over the whole traced window, in %."""

from port_bench import breakdown


def read(ctx):
    if "trace" not in ctx:
        return None
    s = breakdown.stats(ctx)
    return dict(value=100.0 * (1.0 - s["busy_ns"] / s["window_ns"]), unit="%")
