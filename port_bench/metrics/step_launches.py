"""step_launches: CUDA runtime and driver enqueue rows of the traced window
(``spans.LAUNCHES``: kernel launches, async copies and sets, graph
launches) that start inside the program's ``rollout.step`` spans, over the
number of those spans: what one control step (the policy, the env step and
the record) puts on the stream.  Nothing where the program records no
spans (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.launches_per_span(ctx, spans.STEP, "step_launches")
