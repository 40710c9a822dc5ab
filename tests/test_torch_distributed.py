"""Port parity: data-parallel training under ``torch.distributed`` (gloo, CPU).

* ``cuda_step.sharded_cuda_step`` on CPU tensors (its plain version,
  ``fused_step.sharded_fused_step``) over 2 and 4 shards of the mini biped
  (N=16), with and without global-size per-env parameter leaves (gains
  ``[N, nd]``, friction and mass scale ``[N]``, sliced per shard): the
  shards concatenated equal the port's unsharded step bit for bit (the
  step is per env), and match the JAX package's ``sharded_pallas_step``
  (interpret mode) on ``make_mesh(2)`` / ``make_mesh(4)`` of the virtual
  CPU devices within ``physics.testing.step_tolerances()``.
* A two-rank ``train_iter`` on the G1-shaped fixture (16 global envs, 8
  per rank, T=4, ``fc_2layers_64units``, ``batch_size`` 2) against the JAX
  package's ``train_iter`` on ``make_mesh(2)``: the JAX draws are drawn as
  global arrays and sliced per rank, and each rank's minibatch
  permutations are JAX's per-device ones, ``permutation(split(fold_in(
  k_upd, d), epochs)[e], nblk)``.  Parameters within 2 lr and at most 1% of
  the elements beyond 0.05 lr (the f32 tolerance of
  tests/test_torch_train.py, whose docstring says why); the normalizers,
  the sampler errors and the infos within 1e-5; both ranks hold the same
  train state bit for bit.
* The contract of tests/test_distributed.py at this size: two ranks train
  2 iterations through ``Trainer``, save, a second ``Trainer`` resumes at
  iteration 2 with the saved state bit for bit and trains to 3, and the
  ranks' train states hash the same; a third resumes where only rank 0's
  ``log_dir`` holds the checkpoint, and both ranks take rank 0's state.

The ranks are JAX-free worker processes (tests/torch_distributed_worker.py)
that this test starts.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.parallel.mesh import make_mesh, replicate_tree, shard_env_tree
from add_gym_tpu.physics import engine as jeng
from add_gym_tpu.physics.fused_step import FusedModelConstants as JaxFMC
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_tpu.physics.pallas_step import sharded_pallas_step
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.learning.add_agent import train_state_dict
from add_gym_torch.learning.convert import _flax_like_params, from_jax
from add_gym_torch.parallel.mesh import EnvShard
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import EngineParams, SimState
from add_gym_torch.physics.fused_step import FusedModelConstants, fused_step
from add_gym_torch.physics.model import build_physics_model
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
N, T = 16, 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(mode, out_dir, world=2, timeout=240):
    """Start ``world`` worker ranks and return their results."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    logs, procs = [], []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"worker_{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, mode, str(rank), str(world), port, str(out_dir)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
        for log in logs:
            log.close()
    tails = "\n".join(open(os.path.join(out_dir, f"worker_{r}.log")).read()[-3000:]
                      for r in range(world))
    assert rcs == [0] * world, tails
    return [torch.load(os.path.join(out_dir, f"result_{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------ the sharded step


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    path = fx.write_mini_mjcf(str(tmp_path_factory.mktemp("mini")))
    tmodel, jmodel = build_physics_model(path), jax_build_model(path)
    return tmodel, FusedModelConstants(tmodel), JaxFMC(jmodel)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_sharded_step_matches_unsharded_and_jax(mini, shards, per_env):
    model, fc, jfc = mini
    kp = np.full(model.nd, 50.0, np.float32)
    kv = np.full(model.nd, 5.0, np.float32)
    leaves = dict(kp=kp, kv=kv)
    if per_env:
        leaves = fx.per_env_params(kp, kv, N, seed=21)
    tp = EngineParams(**{k: torch.as_tensor(v) for k, v in leaves.items()})
    jp = jeng.EngineParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    fields, cmd = fx.random_sim_state(model, N, seed=22, height=0.6)
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    tcmd = torch.as_tensor(cmd)

    whole, contact = fused_step(fc, tp, state, tcmd)
    n = N // shards
    before = cs.sharded_cuda_step.launches
    parts = [cs.sharded_cuda_step(
        fc, tp, SimState(**{k: v[r * n:(r + 1) * n] for k, v in state.__dict__.items()}),
        tcmd[r * n:(r + 1) * n], EnvShard(r * n, (r + 1) * n, N)) for r in range(shards)]
    assert cs.sharded_cuda_step.launches == before          # CPU tensors: no launch
    got = {f: torch.cat([getattr(p[0], f) for p in parts]) for f in fx.STATE_FIELDS}
    got["contact"] = torch.cat([p[1] for p in parts])
    for f in fx.STATE_FIELDS:
        assert torch.equal(got[f], getattr(whole, f)), f
    assert torch.equal(got["contact"], contact)

    mesh = make_mesh(shards)
    jp_sh = jax.tree_util.tree_map(
        lambda x: shard_env_tree(mesh, x) if jnp.ndim(x) >= 1 and jnp.shape(x)[0] == N else x, jp)
    js = shard_env_tree(mesh, jeng.SimState(**{k: jnp.asarray(v) for k, v in fields.items()}))
    s_out, c_out = jax.jit(lambda p, s, t: sharded_pallas_step(jfc, mesh, p, s, t, interpret=True))(
        jp_sh, js, shard_env_tree(mesh, jnp.asarray(cmd)))
    want = {f: np.asarray(getattr(s_out, f)) for f in fx.STATE_FIELDS}
    want["contact"] = np.asarray(c_out)
    assert (want["contact"] > 0).any()
    for f, tol in fx.step_tolerances().items():
        np.testing.assert_allclose(got[f].numpy(), want[f], **tol, err_msg=f)


# ------------------------------------------------ two-rank train_iter


def _cfg(load, mjcf, clip, tmp=None):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["task"]["motion_file"] = clip
    cfg["engine"]["num_envs"] = N
    cfg["agent"]["steps_per_iter"] = T
    cfg["agent"]["batch_size"] = 2
    cfg["agent"]["mixed_precision"] = False
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    if tmp is not None:
        cfg.update(device="cpu", log_dir=str(tmp), experiment_name="dp", test_episodes=0)
    return cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    return fx.write_g1_fixture(str(d)), fx.write_motion_csv(str(d / "clip.motion"), seed=5,
                                                            num_frames=120)


def _to_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_two_rank_train_iter_matches_jax(files, tmp_path):
    jcfg = _cfg(jax_load_config, *files)
    mesh = make_mesh(2)
    jenv = jax_build_env(jcfg, mesh=mesh)
    jagent = jax_build_agent(jcfg, jenv)
    jts = jagent.init_train_state(jax.random.PRNGKey(7))
    rng = np.random.default_rng(11)
    d = jenv.obs_dim()
    mean = rng.normal(0.0, 0.3, d).astype(np.float32)
    std = rng.uniform(0.5, 2.0, d).astype(np.float32)
    jts = dataclasses.replace(
        jts,
        obs_norm=dataclasses.replace(jts.obs_norm, count=jnp.float32(100.0), mean=jnp.asarray(mean),
                                     mean_sq=jnp.asarray(std * std + mean * mean)),
        disc_norm=dataclasses.replace(
            jts.disc_norm, count=jnp.float32(100.0),
            mean_abs=jnp.asarray(rng.uniform(0.05, 0.5, jts.disc_norm.mean_abs.shape), jnp.float32)),
        sampler=dataclasses.replace(
            jts.sampler,
            errors=jnp.asarray(rng.uniform(0.5, 2.0, jts.sampler.errors.shape), jnp.float32)),
    )
    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(N), jnp.ones(N, bool), jts.sampler)
    ep_time = np.zeros(N, np.float32)
    ep_time[[1, 12]] = jcfg["task"]["max_episode_length"] - 0.005   # one reset on each rank
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    jobs = jenv.compute_obs(jes)
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, N)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)

    key = jax.random.PRNGKey(9)
    k_roll, _, k_upd = jax.random.split(key, 3)
    k_noise, k_bern, k_ids, k_times, _ = jax.random.split(k_roll, 5)
    noise = jax.random.normal(k_noise, (T, N, jenv.num_dofs))
    bern = jax.random.bernoulli(k_bern, jagent._exp_prob(jts.sample_count), (T, N, 1))
    ids_f = jenv.motion.sample_motions(k_ids, T * N)
    times_f = jenv._sample_times(k_times, ids_f, jts.sampler).reshape(T, N)
    draws = tuple(torch.as_tensor(np.array(x, np.float32 if x.dtype == bool else x.dtype))
                  for x in (noise, bern, ids_f.reshape(T, N), times_f))
    epochs, nblk = jagent.cfg.update_epochs, 4     # 32 local rows in blocks of 8
    perms = [[np.asarray(jax.random.permutation(k, nblk))
              for k in jax.random.split(jax.random.fold_in(k_upd, dev), epochs)]
             for dev in range(2)]

    tcfg = _cfg(load_config, *files)
    tagent = build_agent(tcfg, build_env(tcfg, device="cpu"))
    torch.save(dict(cfg=tcfg, train_state=train_state_dict(from_jax(tagent, jts)),
                    reset_ids=torch.as_tensor(np.array(r_ids), dtype=torch.int64),
                    reset_times=torch.as_tensor(np.array(r_times)),
                    ep_time=torch.as_tensor(ep_time), draws=draws, perms=perms),
               tmp_path / "inputs.pt")

    jts, jes, jobs = (replicate_tree(mesh, jts), shard_env_tree(mesh, jes),
                      shard_env_tree(mesh, jobs))
    jts2, jes2, jobs2, jinfo = jagent.train_iter(jts, jes, jobs, key)
    res = _run_ranks("train_iter", str(tmp_path))

    assert [r["world_size"] for r in res] == [2, 2]
    assert res[0]["hash"] == res[1]["hash"]          # one model on both ranks
    assert float(jinfo["done_frac"]) > 0.0
    for r in res:
        info = r["info"]
        assert set(info) == set(jinfo)
        for k in jinfo:
            np.testing.assert_allclose(_to_np(info[k]), _to_np(jinfo[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    ts = res[0]["train_state"]
    net = tagent.init_train_state().params
    net.load_state_dict(ts["params"])
    want = _flax_like_params(net, jts2.params)
    diffs = np.concatenate([(p.detach() - w).abs().flatten().numpy()
                            for p, w in zip(net.parameters(), want)])
    assert diffs.max() <= 2 * LR, f"max |delta| {diffs.max() / LR:.3f} lr"
    assert np.mean(diffs > 0.05 * LR) <= 0.01
    for f in ("count", "mean", "mean_sq"):
        np.testing.assert_allclose(_to_np(ts["obs_norm"][f]), _to_np(getattr(jts2.obs_norm, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f"obs_norm.{f}")
    for f in ("count", "mean_abs"):
        np.testing.assert_allclose(_to_np(ts["disc_norm"][f]), _to_np(getattr(jts2.disc_norm, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f"disc_norm.{f}")
    np.testing.assert_allclose(_to_np(ts["sampler_errors"]), _to_np(jts2.sampler.errors),
                               rtol=1e-5, atol=1e-5)
    assert int(ts["sample_count"]) == int(jts2.sample_count) == T * N
    jobs2, jids2 = np.asarray(jobs2), np.asarray(jes2.motion_ids)
    for rank, r in enumerate(res):
        sl = slice(rank * N // 2, (rank + 1) * N // 2)
        np.testing.assert_allclose(r["obs"].numpy(), jobs2[sl], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r["motion_ids"].numpy(), jids2[sl])


@pytest.fixture(scope="module")
def resumed(files, tmp_path_factory):
    """The two ranks of the worker's ``resume`` mode, and their directory."""
    tmp_path = tmp_path_factory.mktemp("resume")
    torch.save(dict(cfg=_cfg(load_config, *files, tmp=tmp_path / "logs")), tmp_path / "inputs.pt")
    return _run_ranks("resume", str(tmp_path)), tmp_path


def test_two_rank_train_save_resume(resumed):
    res, tmp_path = resumed
    for r in res:
        assert r["world_size"] == 2
        assert r["samples_run1"] == 2 * T * N          # 2 iterations x 4 steps x 16 envs
        assert r["resumed_iter"] == 2
        assert r["samples_resumed"] == 2 * T * N
        assert r["resume_bitwise"] is True
        assert r["samples_final"] == 3 * T * N
    assert res[0]["hash"] == res[1]["hash"]
    assert os.path.exists(tmp_path / "logs" / "dp" / "checkpoint" / "train_state.pt")


def test_two_rank_resume_only_rank0_sees_checkpoint(resumed):
    """Rank 1's log_dir holds no checkpoint: it takes rank 0's state and
    iteration, so the two ranks go on as one model."""
    res, _ = resumed
    for r in res:
        assert r["rank0_only_iter"] == 3
        assert r["rank0_only_hash"] == res[0]["hash"]
