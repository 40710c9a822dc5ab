"""data_ms: device ms of build_train_data an iteration in the traced window: CUDA
events where train_iter's hook marks the phase's end and the previous
one's, summed over the window's iterations and divided by their number."""


def read(ctx):
    if "phase_ms" not in ctx or not ctx["iterations"]:
        return None
    return dict(value=ctx["phase_ms"]["data"] / ctx["iterations"], unit="ms")
