"""The port stands alone: importing every module of ``add_gym_torch`` (its
subpackages ``parallel``, ``cli``, ``render`` and ``native`` included) and
``chip_smoke`` loads neither JAX (nor flax / optax) nor the JAX package,
and every module imports where the optional packages of the tools (PIL,
imageio, matplotlib, mujoco, IPython, huggingface_hub) are absent.

Runs in a fresh interpreter, since this test process has JAX loaded.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
OPTIONAL = ("PIL", "imageio", "matplotlib", "mujoco", "IPython", "huggingface_hub")
for name in OPTIONAL:
    sys.modules[name] = None          # an import of it raises ImportError
import add_gym_torch
names = ["add_gym_torch"] + [
    m.name for m in pkgutil.walk_packages(add_gym_torch.__path__, "add_gym_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "add_gym_tpu"))
print(json.dumps({"modules": len(names), "names": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 55, out
    # the data-parallel bootstrap, the trainer and the CLI are walked too
    # ... and the agent modes' modules (the learned std, the conv trunk, the
    # categorical head, SGD, the JAX-state conversion)
    for name in ("add_gym_torch.parallel.mesh", "add_gym_torch.cli.train",
                 "add_gym_torch.learning.runner", "add_gym_torch.utils.logger",
                 "add_gym_torch.utils.remote", "add_gym_torch.learning.add_agent",
                 "add_gym_torch.learning.networks", "add_gym_torch.learning.distributions",
                 "add_gym_torch.learning.optim", "add_gym_torch.learning.normalizer",
                 "add_gym_torch.learning.convert", "add_gym_torch.envs.imitation",
                 # ... and the tools: the viewer, the probe, the converter, the
                 # publisher, the renderer, the MuJoCo harness, the loader
                 "add_gym_torch.cli.view", "add_gym_torch.cli.probe",
                 "add_gym_torch.cli.convert_motion", "add_gym_torch.cli.publish",
                 "add_gym_torch.render", "add_gym_torch.render.mesh",
                 "add_gym_torch.physics.mujoco_xval", "add_gym_torch.native",
                 "add_gym_torch.robot", "add_gym_torch.kinematics.char_model",
                 # ... and the bench with the counts and peaks it shares with the smoke
                 "add_gym_torch.bench", "add_gym_torch.physics.roofline"):
        assert name in out["names"], name
    assert out["bad"] == [], f"the port imported {out['bad']}"
