"""step_graph_share: the share of the traced window's control steps
(``rollout.step`` spans) that replayed the env's step as a CUDA graph (an
``env.graph`` span inside them), in %.  Nothing where the program records
no spans, or no ``env.graph`` span (``port_bench/spans.py``)."""

import bisect
import sys

from port_bench import spans


def read(ctx):
    got = spans.spans(ctx, "step_graph_share")
    if got is None:
        return None
    graphs = got.get("env.graph")
    if not graphs:
        print("step_graph_share: the program records no env.graph span", file=sys.stderr)
        return None
    steps = got[spans.STEP]
    starts = [s for s, _ in steps]
    graphed = set()
    for s, e in graphs:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= steps[i][1]:
            graphed.add(i)
    return dict(value=100.0 * len(graphed) / len(steps), unit="%")
