"""Program spans on the profiler's clock.

``span(name)`` times a part of the program while a ``torch.profiler`` is
running (the profiler's own on-flag, ``torch.autograd._profiler_enabled``)
and records ``(name, start_ns, end_ns, parent, iteration)`` into a buffer
of this module, on ``time.time_ns()``: ``parent`` is the name of the
enclosing span (None at the root) and ``iteration`` the number of the
``train_iter`` span that holds it (None outside one).  With no profiler
running, ``span`` returns one shared no-op object and records nothing.

The spans are not ``record_function`` ranges: a range that encloses a
kernel launch comes back from kineto as a device-typed annotation too, and
would read as device work.  Instead each ``train_iter`` span emits one
zero-width ``record_function(ANCHOR)``, which encloses no launch and gives
no device row, and keeps its own clock readings just before and after it
as a record named ``ANCHOR`` in the buffer.  :func:`offset` maps the
iteration's spans onto the trace's clock from the two (:func:`place` does
it for a whole trace); on one host the two clocks agree, so the offset is
0 within the readings.

``spans()`` reads the buffer and ``take()`` reads and clears it.  The
recorder adds no device work and no synchronize.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

ANCHOR = "add_gym_torch.trace.anchor"
ROOT = "train_iter"
ANCHOR_LIMIT_NS = 50_000      # an anchor farther than this from its readings maps nothing

_buffer: list = []
_open: list = []               # the spans entered and not yet left, innermost last
_iterations = 0


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "parent", "iteration", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _iterations
        outer = _open[-1] if _open else None
        self.parent = outer.name if outer is not None else None
        self.iteration = outer.iteration if outer is not None else None
        if self.name == ROOT:
            self.iteration = _iterations
            _iterations += 1
            t0 = time.time_ns()
            with record_function(ANCHOR):
                pass
            _buffer.append((ANCHOR, t0, time.time_ns(), ROOT, self.iteration))
        _open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.pop()
        _buffer.append((self.name, self.start, end, self.parent, self.iteration))
        return False


def span(name: str):
    """A context manager that records the time spent inside it while a
    profiler runs; the shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return NOOP
    return _Span(name)


def spans() -> list:
    """The records so far (spans and anchors), in the order they closed."""
    return list(_buffer)


def take() -> list:
    """The records so far, and an empty buffer."""
    out = list(_buffer)
    _buffer.clear()
    return out


def offset(anchor_start_ns: int, anchor_end_ns: int, before_ns: int, after_ns: int) -> int:
    """What to add to this recorder's clock to land on the trace's, from an
    anchor row of the trace and the readings taken just before and after
    it: the value nearest 0 that keeps the row inside the readings."""
    lo, hi = anchor_end_ns - after_ns, anchor_start_ns - before_ns
    return min(max(0, lo), hi)


def place(records: list, anchor_rows: list) -> list:
    """The spans of ``records`` on the trace's clock, as ``(name, start,
    end, parent, iteration)``; ``anchor_rows`` are the trace's ``ANCHOR``
    rows as (start_ns, end_ns).  Each recorded anchor is paired with the
    nearest row; an iteration whose anchor has no row within
    ``ANCHOR_LIMIT_NS`` is left out, and spans outside an iteration take
    the offset of the nearest anchor that maps (0 where none does)."""
    rows = sorted(anchor_rows)
    offsets = {}
    for name, before, after, _, it in records:
        if name != ANCHOR or not rows:
            continue
        start, end = min(rows, key=lambda r: abs(r[0] - before))
        off = offset(start, end, before, after)
        if abs(off) <= ANCHOR_LIMIT_NS:
            offsets[it] = (before, off)
    out = []
    for name, start, end, parent, it in records:
        if name == ANCHOR:
            continue
        if it is None:
            near = min(offsets.values(), key=lambda b: abs(b[0] - start), default=(0, 0))
            off = near[1]
        elif it in offsets:
            off = offsets[it][1]
        else:
            continue
        out.append((name, start + off, end + off, parent, it))
    return out
