"""The traced window's device time: the busy union, the idle gaps and the
device ops that took most time, for the result line's ``device`` and
``breakdown`` and for the readers that need them."""

from __future__ import annotations

from port_bench import trace as tr

TOP = 10


def stats(ctx: dict) -> dict:
    """Busy and idle intervals of the traced window, computed once."""
    if "_stats" not in ctx:
        t = ctx["trace"]
        busy = tr.busy_intervals(t["device"], t["window"])
        ctx["_stats"] = dict(busy=busy, gaps=tr.idle_gaps(busy, t["window"]),
                             busy_ns=sum(b - a for a, b in busy),
                             window_ns=t["window"][1] - t["window"][0])
    return ctx["_stats"]


def busy(ctx: dict) -> dict:
    s = stats(ctx)
    return dict(busy_s=s["busy_ns"] / 1e9, window_s=s["window_ns"] / 1e9)


def breakdown(ctx: dict) -> dict:
    """``device_ops``: the device ops with the most summed time in the
    window; ``idle_gaps``: idle time by the phase and the host op running
    at each gap's middle."""
    t = ctx["trace"]
    w0, w1 = t["window"]
    ops = {}
    for name, s, d in t["device"]:
        a, b = max(s, w0), min(s + d, w1)
        if b > a:
            ops[name] = ops.get(name, 0) + (b - a)
    phase_at = tr.phase_at(t["marks"])
    gaps = stats(ctx)["gaps"]
    mids = [(a + b) // 2 for a, b in gaps]
    idle = {}
    for (a, b), mid, op in zip(gaps, mids, tr.host_ops_at(t["host"], mids)):
        key = f"{phase_at(mid)}/{op or 'python'}"
        idle[key] = idle.get(key, 0) + (b - a)
    top = lambda d: [[k[:96], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(device_ops=top(ops), idle_gaps=top(idle))
