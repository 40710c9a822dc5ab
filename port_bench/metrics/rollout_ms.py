"""rollout_ms: device ms of rollout_lean an iteration in the traced window: CUDA
events where train_iter's hook marks the phase's end and the previous
one's, summed over the window's iterations and divided by their number."""


def read(ctx):
    if "phase_ms" not in ctx or not ctx["iterations"]:
        return None
    return dict(value=ctx["phase_ms"]["rollout"] / ctx["iterations"], unit="ms")
