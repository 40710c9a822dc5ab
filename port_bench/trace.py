"""The traced window: ``torch.profiler`` over the whole measured window, read
straight from its kineto events (no per-event Python objects), with a
marker at the window's start and end and at each phase boundary of every
iteration (``train_iter``'s hook).

What the per-layer readers get: the device ops as (name, start ns, ns),
the window's bounds on the trace's clock, each phase's spans, and the host
ops, for the idle gaps' attribution.
"""

from __future__ import annotations

import bisect

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "port_bench:"
PHASES = ("rollout", "data", "update")


class PhaseHook:
    """``train_iter``'s hook in a traced window: a CUDA event and a trace
    marker where each phase has been issued; ``start`` before each
    iteration."""

    def __init__(self):
        self.events = []                       # per iteration: [(phase, event)]

    def _mark(self, phase):
        with record_function(MARK + phase):
            pass
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[-1].append((phase, ev))

    def start(self):
        self.events.append([])
        self._mark("start")

    def __call__(self, phase, outputs=None):
        self._mark(phase)

    def phase_ms(self) -> dict:
        """Device ms of each phase summed over the iterations (CUDA events:
        start -> rollout -> data -> update)."""
        out = {p: 0.0 for p in PHASES}
        for marks in self.events:
            for (_, a), (b, ev) in zip(marks, marks[1:]):
                if b in out:
                    out[b] += a.elapsed_time(ev)
        return out


class TracedWindow:
    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    @staticmethod
    def mark(name):
        with record_function(MARK + name):
            pass

    def read(self) -> dict:
        """The trace as the readers take it: ``device`` [(name, start, dur)]
        sorted by start, ``host`` the same for CPU ops, ``marks`` {name:
        [start, ...]}, ``window`` (start, end), all in ns of the trace's
        clock."""
        device, host, marks = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith(MARK):
                marks.setdefault(name[len(MARK):], []).append(e.start_ns())
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((name, e.start_ns(), e.duration_ns()))
            else:
                host.append((name, e.start_ns(), e.duration_ns()))
        device.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])
        window = (min(marks["window_start"]), max(marks["window_end"]))
        return dict(device=device, host=host, marks=marks, window=window)


def busy_intervals(device, window):
    """The union of the device ops' intervals inside ``window``, as a
    sorted list of (start, end)."""
    w0, w1 = window
    out = []
    for _, s, d in device:
        a, b = max(s, w0), min(s + d, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def idle_gaps(busy, window):
    w0, w1 = window
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def phase_at(marks: dict):
    """A function from a trace time to the phase the host was issuing
    then (the phase whose end marker comes next)."""
    ends = sorted((t, p) for p in PHASES for t in marks.get(p, []))
    starts = sorted(marks.get("start", []))
    times = [t for t, _ in ends]

    def at(t):
        i = bisect.bisect_left(times, t)
        if i == len(ends):
            return "tail"
        j = bisect.bisect_right(starts, t)
        # past the update's end and before the next start: between iterations
        if j == 0 or (i > 0 and ends[i - 1][0] > starts[j - 1] and ends[i - 1][1] == "update"):
            return "tail"
        return ends[i][1]
    return at


def host_ops_at(host, times):
    """For each of the sorted ``times``, the innermost host op running then
    (the latest-starting op that covers it), or None: one sweep over the
    host ops, sorted by start."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(host) and host[k][1] <= t:
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] + stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out
