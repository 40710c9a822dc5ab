"""minibatch_launches: CUDA runtime and driver enqueue rows of the traced
window (``spans.LAUNCHES``) that start inside the program's
``update.minibatch`` spans, over the number of those spans: what one
minibatch step (gather, loss, gradients, optimizer step) puts on the
stream.  Nothing where the program records no spans
(``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.launches_per_span(ctx, spans.MINIBATCH, "minibatch_launches")
