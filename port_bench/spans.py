"""The program's spans in the traced window, for the readers that look
inside an iteration: the control step, the minibatch step and the device's
idle time under the rollout and the update.

The program (``add_gym_torch.utils.trace``) records its spans on its own
clock while a profiler runs, and at the start of each ``train_iter`` one
zero-width profiler row named ``ANCHOR`` beside its own clock readings just
before and after that row.  Each iteration's spans move onto the trace's
clock by the offset nearest 0 that keeps the anchor's row inside those
readings; the mapping is the benchmark's own, not the program's
(``trace.place``), so that no change to the program moves it.  The spans
are cached in ``ctx`` once, as ``breakdown.stats`` caches the idle gaps,
and the window's idle time by the innermost span at each gap's middle is
printed to standard error then.

Nothing is read (``spans`` returns None and the reason) where the program
records no spans, the trace holds no anchor, an anchor maps farther than
``ANCHOR_LIMIT_NS`` from its readings, or the window's count of control
steps or of minibatch steps is not what its iterations make.
"""

from __future__ import annotations

import bisect
import importlib
import math
import sys

from port_bench import breakdown
from port_bench import trace as tr

ANCHOR = "add_gym_torch.trace.anchor"
ANCHOR_LIMIT_NS = 50_000
# the CUDA runtime and driver calls that put work on a stream
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                      "cudaGraphLaunch"))
STEP, MINIBATCH = "rollout.step", "update.minibatch"
TOP = 10


def _records():
    try:
        mod = importlib.import_module("add_gym_torch.utils.trace")
    except ImportError:
        return None
    return mod.spans()


def _place(ctx: dict):
    """({name: [(start, end)] sorted, on the trace's clock, inside the
    window}, None), or (None, why)."""
    if "trace" not in ctx:
        return None, "no traced window"
    records = _records()
    if not records:
        return None, "the program recorded no spans"
    rows = sorted((s, s + d) for name, s, d in ctx["trace"]["host"] if name == ANCHOR)
    own = sorted((r for r in records if r[0] == ANCHOR), key=lambda r: r[1])
    if not rows or not own:
        return None, f"{len(rows)} anchor rows in the trace, {len(own)} recorded"
    if len(rows) != len(own):
        return None, f"{len(rows)} anchor rows in the trace against {len(own)} recorded"
    offsets = {}
    for (start, end), (_, before, after, _, it) in zip(rows, own):
        off = min(max(0, end - after), start - before)
        if abs(off) > ANCHOR_LIMIT_NS:
            return None, f"iteration {it}'s anchor maps {off} ns from its readings"
        offsets[it] = off
    w0, w1 = ctx["trace"]["window"]
    out = {}
    for name, start, end, _, it in records:
        if name == ANCHOR or it not in offsets:
            continue
        s, e = start + offsets[it], end + offsets[it]
        if w0 <= s and e <= w1:
            out.setdefault(name, []).append((s, e))
    for v in out.values():
        v.sort()
    iters = ctx["iterations"]
    agent = ctx["cfg"]["agent"]
    want = {STEP: ctx["steps"] * iters,
            MINIBATCH: (math.ceil(ctx["steps"] / int(agent["batch_size"]))
                        * int(agent["update_epochs"]) * iters)}
    for name, n in want.items():
        if len(out.get(name, [])) != n:
            return None, (f"{len(out.get(name, []))} {name} spans in the window, expected {n} "
                          f"({iters} iterations)")
    return out, None


def _idle_by_span(ctx: dict, spans: dict) -> None:
    rows = sorted(((name, s, e - s) for name, v in spans.items() for s, e in v),
                  key=lambda r: r[1])
    gaps = breakdown.stats(ctx)["gaps"]
    mids = [(a + b) // 2 for a, b in gaps]
    idle = {}
    for (a, b), name in zip(gaps, tr.host_ops_at(rows, mids)):
        idle[name or "(none)"] = idle.get(name or "(none)", 0) + (b - a)
    total = sum(idle.values()) or 1
    print("idle by program span (s, share of idle): " + ", ".join(
        f"{k} {v / 1e9:.3f} {100.0 * v / total:.1f}%"
        for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]), file=sys.stderr)


def spans(ctx: dict, metric: str):
    """The window's spans by name, or None after printing why ``metric``
    reads nothing."""
    if "_spans" not in ctx:
        ctx["_spans"] = _place(ctx)
        if ctx["_spans"][0] is not None:
            _idle_by_span(ctx, ctx["_spans"][0])
    got, why = ctx["_spans"]
    if got is None:
        print(f"{metric}: {why}", file=sys.stderr)
    return got


def launches_per_span(ctx: dict, name: str, metric: str):
    """Launch rows (``LAUNCHES``) that start inside the window's ``name``
    spans, over their number."""
    got = spans(ctx, metric)
    if got is None:
        return None
    if "_launch_starts" not in ctx:
        ctx["_launch_starts"] = [s for n, s, _ in ctx["trace"]["host"] if n in LAUNCHES]
    starts = ctx["_launch_starts"]          # the host rows are sorted by start
    n = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in got[name])
    return dict(value=n / len(got[name]), unit="launches")


def mean_ms(ctx: dict, name: str, metric: str):
    """The mean host duration of the window's ``name`` spans."""
    got = spans(ctx, metric)
    if got is None:
        return None
    return dict(value=sum(e - s for s, e in got[name]) / len(got[name]) / 1e6, unit="ms")


def idle_ms_per_iteration(ctx: dict, name: str, metric: str):
    """The window's idle device time inside ``name`` spans, per iteration."""
    got = spans(ctx, metric)
    if got is None or not ctx["iterations"]:
        return None
    gaps, idle, i = breakdown.stats(ctx)["gaps"], 0, 0
    for s, e in got.get(name, []):
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            idle += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return dict(value=idle / 1e6 / ctx["iterations"], unit="ms")
