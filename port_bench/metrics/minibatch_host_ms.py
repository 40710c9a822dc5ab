"""minibatch_host_ms: the mean host duration of the program's
``update.minibatch`` spans in the traced window, ms.  Nothing where the
program records no spans (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.mean_ms(ctx, spans.MINIBATCH, "minibatch_host_ms")
