"""step_host_ms: the mean host duration of the program's ``rollout.step``
spans in the traced window, ms: the host time of one control step (the
policy, the env step and the record).  Nothing where the program records
no spans (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.mean_ms(ctx, spans.STEP, "step_host_ms")
