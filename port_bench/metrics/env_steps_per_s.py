"""env_steps_per_s: all env steps of the whole iterations that completed in
the window, over its time on the host clock (from the window's start to
the synchronize after the last iteration)."""


def read(ctx):
    return dict(value=ctx["env_steps"] / ctx["window_s"], unit="env-steps/s")
