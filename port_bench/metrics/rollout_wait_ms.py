"""rollout_wait_ms: the traced window's idle device time (its idle gaps,
``breakdown.stats``) inside the program's ``rollout`` spans, ms an
iteration: how long the card waits on the host during the rollout.
Nothing where the program records no spans (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.idle_ms_per_iteration(ctx, "rollout", "rollout_wait_ms")
