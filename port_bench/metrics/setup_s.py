"""setup_s: from the process's start to the window's start: imports, the
inputs, the build of the env and agent (and of the kernel, in a checkout's
first run), the weights and the followed iterations, the first of which
warms up every shape the window uses."""


def read(ctx):
    return dict(value=ctx["setup_s"], unit="s")
