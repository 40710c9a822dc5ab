"""The port's bench, ``add_gym_torch.bench`` (CPU).

* ``derived_ceiling`` with every peak at 197e12 and a physics term of
  0.33 ms a step equals the root ``bench.derived_ceiling(...,
  phys_ms_per_step=0.33)`` at rtol 1e-12, for ``add_g1``, ``amp_g1`` and
  ``ppo_g1`` and at 128 steps an iteration; the JAX side gets a stub agent
  with the port agent's ``cfg`` and parameter counts (``bench.py`` is
  imported, not edited).
* ``net_params_by_trunk`` equals the JAX agent's on the G1-shaped fixture
  at the ``train`` widths, for each agent group.
* The precision split: the disc at f32 under ``add_g1``, the actor and
  critic at bf16 under ``mixed_precision``; each flag moves its trunks.
* On the H100's peaks the ``train`` ceiling at 4096 envs is what PERF.md
  derives by hand; the kernel's bound, its physics term, stays 0.01280 ms
  for the main variant at 4096 envs; an unknown card has no peaks.
* ``python -m add_gym_torch.bench`` under ``BENCH_OVERRIDES="device=cpu
  engine.kernel=off"`` at 8 envs x 2 steps with 1-iteration windows
  prints exactly one JSON line with ``bench.py``'s keys, ``device_kind``
  ``"cpu"`` and null for ``floor_ratio`` and every device-only number;
  with ``device=cuda`` and no card it exits non-zero and prints none.
* ``run_protocol`` raises, on a small CPU slice, where an info is not
  finite, where the parameters do not move (learning rate 0) and where
  the launches differ from what the config selects.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch import bench
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.roofline import PEAKS, control_step_bound, device_peaks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "floor_ratio", "derived_ceiling",
              "device_kind", "windows")
DEVICE_ONLY = ("power_limit_w", "ceiling_ms", "split_ms", "iter_ms",
               "kernel_ms_per_launch", "kernel_bound_ms", "kernel_bound_by",
               "peak_device_bytes", "device_busy_share")
AGENTS = ["add_g1", "amp_g1", "ppo_g1"]


@pytest.fixture(scope="module")
def root_bench():
    """The repository's bench.py, imported from its file (it sets a JAX
    cache directory default, which is restored)."""
    before = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if before is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = before
    return mod


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench"))


def _port_agent(fixture_dir, overrides=(), num_envs=8):
    cfg = fx.slice_config(fixture_dir, "train", list(overrides) + ["device=cpu"])
    cfg["engine"]["num_envs"] = num_envs
    env = build_env(cfg, device="cpu")
    return env, build_agent(cfg, env)


@pytest.fixture(scope="module")
def agents(fixture_dir):
    return {group: _port_agent(fixture_dir, [f"agent={group}"]) for group in AGENTS}


class _Stub:
    """What bench.derived_ceiling reads of a JAX agent."""

    def __init__(self, cfg, params):
        self.cfg, self._params = cfg, params

    def net_params_by_trunk(self):
        return self._params


@pytest.mark.parametrize("group,steps", [("add_g1", None), ("amp_g1", None), ("ppo_g1", None),
                                         ("add_g1", 128)])
def test_ceiling_matches_root_bench(root_bench, agents, group, steps):
    agent = agents[group][1]
    if steps is not None:
        agent = _Stub(dataclasses.replace(agent.cfg, steps_per_iter=steps),
                      agent.net_params_by_trunk())
    stub = _Stub(agent.cfg, agent.net_params_by_trunk())
    peaks = dict(bf16=197e12, f32=197e12)
    got_rate, got_s, terms = bench.derived_ceiling(agent, 4096, peaks, 0.33)
    want_rate, want_s = root_bench.derived_ceiling(stub, 4096, "TPU v5 lite", phys_ms_per_step=0.33)
    np.testing.assert_allclose([got_rate, got_s], [want_rate, want_s], rtol=1e-12)
    assert terms["physics"] == pytest.approx(agent.cfg.steps_per_iter * 0.33e-3, rel=1e-12)


@pytest.mark.parametrize("group", AGENTS)
def test_net_params_match_jax(agents, fixture_dir, group):
    agent = agents[group][1]
    jcfg = jax_load_config("train", [f"agent={group}"])
    jcfg["robot"]["asset_path"], jcfg["task"]["motion_file"] = fx.write_slice_files(fixture_dir)
    jcfg["engine"]["num_envs"] = 8
    jenv = jax_build_env(jcfg)
    want = jax_build_agent(jcfg, jenv).net_params_by_trunk()
    assert agent.net_params_by_trunk() == want
    if group == "add_g1":       # the G1-shaped fixture at the train widths
        assert want == dict(actor=1858048, critic=1843712, disc=641536), want


def test_precision_split(agents):
    cfg = agents["add_g1"][1].cfg
    assert bench.trunk_precisions(cfg) == dict(actor="bf16", critic="bf16", disc="f32")
    assert bench.trunk_precisions(dataclasses.replace(cfg, disc_mixed_precision=True)) == \
        dict(actor="bf16", critic="bf16", disc="bf16")
    assert bench.trunk_precisions(dataclasses.replace(cfg, mixed_precision=False)) == \
        dict(actor="f32", critic="f32", disc="f32")
    assert bench.trunk_precisions(agents["amp_g1"][1].cfg)["actor"] == "f32"


def test_h100_ceiling(agents):
    """The ``train`` ceiling at 4096 envs on the H100's data-sheet peaks:
    16.010 TFLOP of bf16 matmuls (16.19 ms), 5.213 TFLOP of f32 (77.81
    ms) and 32 x 0.01280 ms of physics: 94.41 ms, 1.3883 M env-steps/s."""
    env, agent = agents["add_g1"]
    bound_ms, bound_by = bench.kernel_bound(env, env.params, 4096)
    assert (round(bound_ms, 5), bound_by) == (0.01280, "operations")
    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == dict(bf16=989e12, f32=67e12, bytes=3.35e12)
    rate, floor_s, terms = bench.derived_ceiling(agent, 4096, peaks, bound_ms)
    assert terms["bf16"] * 1e3 == pytest.approx(16.19, abs=0.005)
    assert terms["f32"] * 1e3 == pytest.approx(77.81, abs=0.005)
    assert terms["physics"] * 1e3 == pytest.approx(32 * 0.01280, rel=1e-3)
    assert floor_s * 1e3 == pytest.approx(94.41, abs=0.005)
    assert rate == pytest.approx(1.3883e6, rel=1e-4)
    assert device_peaks("NVIDIA A100-SXM4-80GB") is None and set(PEAKS) == {
        "NVIDIA H100 80GB HBM3"}


def test_kernel_bounds_unchanged(fixture_dir):
    """The bounds of PERF.md's kernel table: main 0.01280, per-env 0.01303,
    with narrowphase rows 0.01281 ms at 4096 envs; 0.00640 at 2048."""
    for overrides, n, want in (((), 4096, 0.01280), ((), 2048, 0.00640),
                               (("engine.general_narrowphase=true",), 4096, 0.01281)):
        env, _ = _port_agent(fixture_dir, overrides)
        assert round(bench.kernel_bound(env, env.params, n)[0], 5) == want
    env, _ = _port_agent(fixture_dir)
    fbuf, ibuf, counts = cs.pack_model(env._fc, env.params, per_env=True)
    assert round(control_step_bound(fbuf, ibuf, counts, 4096, per_env=True)[0], 5) == 0.01303


def _run_bench(overrides, **knobs):
    env = dict(os.environ, BENCH_OVERRIDES=overrides,
               **{f"BENCH_{k.upper()}": str(v) for k, v in knobs.items()})
    return subprocess.run([sys.executable, "-m", "add_gym_torch.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def test_bench_runs_on_the_cpu():
    proc = _run_bench("device=cpu engine.kernel=off", num_envs=8, steps_per_iter=2, iters=1,
                      windows=1)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1 and len(_json_lines(proc.stdout)) == 1, proc.stdout
    out = json.loads(lines[0])
    assert set(BENCH_KEYS) <= set(out)
    assert out["device_kind"] == "cpu" and out["floor_ratio"] is None
    assert out["derived_ceiling"] is None
    assert all(out[k] is None for k in DEVICE_ONLY), {k: out[k] for k in DEVICE_ONLY}
    assert out["unit"] == "env-steps/s" and len(out["windows"]) == 1 and out["value"] > 0
    assert "[cpu]" in out["metric"] and "G1-shaped fixture" in out["metric"]
    assert out["vs_baseline"] == round(out["value"] / 1e6, 4)
    assert (out["num_envs"], out["steps_per_iter"], out["kernel_launches_per_iter"]) == (8, 2, 0)
    assert out["trunk_precision"] == dict(actor="bf16", critic="bf16", disc="f32")


def test_bench_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for overrides in ("device=cuda", ""):
        proc = _run_bench(overrides, num_envs=8, steps_per_iter=2, iters=1, windows=1)
        assert proc.returncode != 0 and _json_lines(proc.stdout) == [], proc.stdout
        assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]


def _small(fixture_dir, overrides=()):
    env, agent = _port_agent(fixture_dir, ["agent.steps_per_iter=2", "agent.mixed_precision=false",
                                           *[f"agent.{k}=fc_2layers_64units" for k in
                                             ("actor_net", "critic_net", "disc_net")],
                                           *overrides], num_envs=4)
    return env, agent


@pytest.mark.parametrize("fault", ["nan_info", "frozen", "launches"])
def test_protocol_checks(fixture_dir, monkeypatch, fault):
    env, agent = _small(fixture_dir, ["agent.learning_rate=0.0"] if fault == "frozen" else [])
    out = bench.run_protocol(env, agent, 4, iters=1, windows=1) if fault == "launches" else None
    if fault == "launches":      # the clean run passes; one launch too many fails
        assert out["kernel_launches_per_iter"] == 0 and out["device_kind"] == "cpu"
        monkeypatch.setattr(bench, "read_counts", lambda: dict(main=1, per_env=0, narrowphase=0,
                                                               sharded=0))
        match = "kernel launches"
    elif fault == "nan_info":
        train_iter = agent.train_iter

        def poisoned(*args, **kw):
            ts, es, obs, info = train_iter(*args, **kw)
            return ts, es, obs, dict(info, loss=torch.tensor(float("nan")))

        monkeypatch.setattr(agent, "train_iter", poisoned)
        match = "not finite"
    else:
        match = "unchanged"
    with pytest.raises(RuntimeError, match=match):
        bench.run_protocol(env, agent, 4, iters=1, windows=1)
