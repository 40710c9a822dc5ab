"""add-gym-torch: the PyTorch/CUDA port of add-gym-tpu for NVIDIA Hopper.

Same module layout as ``add_gym_tpu`` so each module's counterpart is easy
to find.  Plain tensor code is PyTorch; the physics control step, which the
JAX package runs as a Pallas kernel, runs here as a hand-written CUDA
kernel (``physics/cuda_step.py``, sources under ``csrc/``).

Public entry points::

    from add_gym_torch import load_config, build_env, build_agent

the training CLI, ``python -m add_gym_torch.cli.train`` (data-parallel
under ``python -m torch.distributed.run``, ``parallel/mesh.py``), and the
tools: ``cli.view`` (clip playback and video), ``cli.probe``,
``cli.convert_motion`` and ``cli.publish``.

Submodules are imported lazily so that light uses (the config system, the
model parser) do not pay for the whole package.
"""

__version__ = "0.1.0"

__all__ = ["build_agent", "build_env", "load_config", "__version__"]


def __getattr__(name):
    if name in ("build_env", "build_agent"):
        from add_gym_torch import builder

        return getattr(builder, name)
    if name == "load_config":
        from add_gym_torch.utils.config import load_config

        return load_config
    raise AttributeError(f"module 'add_gym_torch' has no attribute {name!r}")
