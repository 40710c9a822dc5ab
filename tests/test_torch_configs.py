"""Every top-level config of the port composes to the JAX package's.

For each top-level config both packages ship, the port's composed
``engine``, ``agent``, ``task`` and ``robot`` blocks, its other top-level
values and its set of config groups equal the JAX package's composed
config, apart from the backend keys: ``engine.pallas`` (JAX) against
``engine.kernel`` (the port), the port's top-level ``device``, and what
the ``distributed`` group holds (a device mesh in JAX, the
``torch.distributed`` backend in the port; both packages must have the
group or both lack it).  The JAX engine's ``domain_rand`` block is
completed with ``DRConfig``'s defaults, which the JAX package's
``build_env`` applies and the port's ``engine/gpu.yaml`` spells out.

So ``dr_pod`` holds its 16,384 global envs under ``distributed: mesh`` in
both packages: one card runs it with ``engine.num_envs=4096``.
"""

import dataclasses
import os

import pytest

from add_gym_tpu.envs.domain_rand import DRConfig
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["add4096", "dr_pod", "multihost", "parity_cpu4", "ppo256", "test", "train", "view"]
BACKEND_ENGINE_KEYS = ("pallas", "kernel")


def _top_level(package):
    d = os.path.join(REPO, package, "configs")
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".yaml"))


def _effective(cfg, jax_side):
    """The config with the backend keys taken out (and, for the JAX
    package, ``DRConfig``'s defaults filled in)."""
    cfg = dict(cfg)
    engine = {k: v for k, v in cfg.get("engine", {}).items() if k not in BACKEND_ENGINE_KEYS}
    if "domain_rand" in engine and jax_side:
        defaults = {f.name: f.default for f in dataclasses.fields(DRConfig)}
        engine["domain_rand"] = {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in {**defaults, **engine["domain_rand"]}.items()}
    cfg["engine"] = engine
    cfg.pop("device", None)
    if "distributed" in cfg:
        cfg["distributed"] = "present"
    return cfg


def test_same_top_level_configs():
    assert _top_level("add_gym_torch") == _top_level("add_gym_tpu") == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    port = _effective(load_config(name), jax_side=False)
    ref = _effective(jax_load_config(name), jax_side=True)
    assert sorted(port) == sorted(ref), "config groups or top-level keys differ"
    for key in sorted(ref):
        assert port[key] == ref[key], f"{name}: {key} differs"


def test_dr_pod_is_the_pod_config():
    """dr_pod's env count is global over the ranks, as in the JAX package,
    and an override gives one card its share."""
    cfg = load_config("dr_pod")
    assert cfg["engine"]["num_envs"] == 16384 and "distributed" in cfg
    assert cfg["engine"]["domain_rand"]["enabled"]
    assert load_config("dr_pod", ["engine.num_envs=4096"])["engine"]["num_envs"] == 4096
