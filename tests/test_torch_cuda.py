"""The CUDA control-step kernel on a card (marker ``cuda``; skips without one).

Run on a machine with an NVIDIA GPU and no JAX from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX.)  This file imports
nothing of JAX.  Tolerances are ``physics.testing.step_tolerances()`` for
one step, and rtol = atol = 1e-3 for a 4-step rollout.  The per-env
(domain-randomization) variant is held to the plain step the same way, and
a small ``train_iter`` on the ``dr_pod`` config runs through it; so do
one of AMP (``agent=amp_g1``) and one of plain PPO (``agent=ppo_g1``),
each held to the plain step within the ``dr_pod`` case's tolerances.  Both
variants with the held narrowphase rows (the G1-shaped fixture with its
geom tables) are held to the plain step too, and two ``compute_np_ext``
calls on the same input must give the same bits.  The sharded step
(``sharded_cuda_step``, per-rank launches of the same kernel) concatenated
over 2 and 4 shards equals the unsharded kernel bit for bit at 4096 envs,
and a one-rank ``Trainer`` on the card saves and resumes bit for bit.  The
video path: ``eval_rollout_states`` through the kernel (the main variant,
and the per-env one under ``dr_pod``) matches the plain step over 8 steps
at 64 envs within rtol = atol = 1e-3 (the rollout tolerance), FK on the
card matches FK on the CPU within 1e-5, and a one-rank ``Trainer`` with
``video_interval=1`` writes its pose dump (400 launches for the 4-s video).  The
kernel steps each env by one warp: two launches on one input give the same
bits for every instance; it matches the plain step at N = 1, 37, 4000 and
4096 (less than a block, ragged, full); a model of 32 bodies (the narrow
instance's most) and the G1 with Dex3-1 hands (44 bodies, the wide
instance: main, per-env, narrowphase rows, the graphed rollout, each
counted in ``wide_launches``) run while 49 bodies are refused.  A traced
``train_iter`` of ``train`` and of ``dr_pod`` at 64 envs: no device row carries a program
span's name, and each kernel's launch row (the env step's graph launch)
lies inside an ``env.graph`` span.  ``rollout_lean``'s env step as one
CUDA graph (main variant, per-env with latency and mass, narrowphase
rows): bit for bit equal to the eager step over two chained 8-step
rollouts with resets, one capture a rollout, its launches counted, its
buffers freed.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.envs import imitation
from add_gym_torch.envs.imitation import ImitationEnv
from add_gym_torch.learning.add_agent import state_digest
from add_gym_torch.learning.runner import Trainer
from add_gym_torch.parallel.mesh import EnvShard
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import EngineParams, SimState
from add_gym_torch.physics.fused_step import (
    FusedModelConstants, compute_np_ext, fused_step, np_rows,
)
from add_gym_torch.physics.model import attach_geoms, build_physics_model
from add_gym_torch.robot import build_pd_gains
from add_gym_torch.utils import trace
from add_gym_torch.utils.config import load_config
from port_bench import inputs

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = str(tmp_path_factory.mktemp("cuda"))
    g1_dex3, dex3_clip = inputs.write_inputs(d, clip_seed=0, name="g1_dex3")
    return dict(
        mini=fx.write_mini_mjcf(d), g1=fx.write_g1_fixture(d), mesh=fx.write_mesh_fixture(d),
        clip=fx.write_motion_csv(d + "/clip.motion", seed=0, num_frames=120),
        g1_dex3=g1_dex3, dex3_clip=dex3_clip,
    )


def _model(path, g1):
    model = build_physics_model(path)
    if g1:
        kp, kv = build_pd_gains(model)
    else:
        kp = np.full(model.nd, 50.0, np.float32)
        kv = np.full(model.nd, 5.0, np.float32)
    params = EngineParams(kp=torch.as_tensor(kp, device="cuda"),
                          kv=torch.as_tensor(kv, device="cuda"))
    return model, FusedModelConstants(model), params


@pytest.mark.parametrize("which", ["mini", "g1", "g1_dex3"])
def test_kernel_matches_plain_step(paths, which):
    """The main variant; on the G1 with Dex3-1 hands (44 bodies) its wide
    instance, counted in ``wide_launches``."""
    model, fc, params = _model(paths[which], which != "mini")
    height = fx.G1_PELVIS_HEIGHT if which != "mini" else 0.6
    n = 1000                                        # a ragged last block
    fields, cmd = fx.random_sim_state(model, n, seed=11, height=height)
    state = SimState(**{k: torch.as_tensor(v, device="cuda") for k, v in fields.items()})
    cmd = torch.as_tensor(cmd, device="cuda")
    before, wide = cs.cuda_step.launches, cs.cuda_step.wide_launches
    k_state, k_contact = cs.cuda_step(fc, params, state, cmd)
    p_state, p_contact = fused_step(fc, params, state, cmd)
    torch.cuda.synchronize()
    assert cs.cuda_step.launches == before + 1
    assert cs.cuda_step.wide_launches == wide + (which == "g1_dex3")
    assert k_contact.shape == (n, model.nb) and k_contact.is_cuda
    assert (p_contact > 0).any()
    for f, tol in fx.step_tolerances().items():
        got = k_contact if f == "contact" else getattr(k_state, f)
        want = p_contact if f == "contact" else getattr(p_state, f)
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{f}: {m}")


@pytest.mark.parametrize("which", ["mini", "g1", "g1_dex3"])
def test_per_env_kernel_matches_plain_step(paths, which):
    model, fc, params = _model(paths[which], which != "mini")
    height = fx.G1_PELVIS_HEIGHT if which != "mini" else 0.6
    n = 1000
    fields, cmd = fx.random_sim_state(model, n, seed=12, height=height)
    pe = fx.per_env_params(params.kp.cpu().numpy(), params.kv.cpu().numpy(), n, seed=13)
    params = dataclasses.replace(
        params, **{k: torch.as_tensor(v, device="cuda") for k, v in pe.items()})
    state = SimState(**{k: torch.as_tensor(v, device="cuda") for k, v in fields.items()})
    cmd = torch.as_tensor(cmd, device="cuda")
    before, before_dr = cs.cuda_step.launches, cs.cuda_step.dr_launches
    wide = cs.cuda_step.wide_launches
    k_state, k_contact = cs.cuda_step(fc, params, state, cmd)
    p_state, p_contact = fused_step(fc, params, state, cmd)
    torch.cuda.synchronize()
    assert (cs.cuda_step.launches, cs.cuda_step.dr_launches) == (before, before_dr + 1)
    assert cs.cuda_step.wide_launches == wide + (which == "g1_dex3")
    assert (p_contact > 0).any()
    for f, tol in fx.step_tolerances().items():
        got = k_contact if f == "contact" else getattr(k_state, f)
        want = p_contact if f == "contact" else getattr(p_state, f)
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{f}: {m}")


def _assert_matches_plain(fc, params, state, cmd, k_state, k_contact):
    p_state, p_contact = fused_step(fc, params, state, cmd)
    torch.cuda.synchronize()
    for f, tol in fx.step_tolerances().items():
        got = k_contact if f == "contact" else getattr(k_state, f)
        want = p_contact if f == "contact" else getattr(p_state, f)
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{f}: {m}")
    return p_contact


@pytest.mark.parametrize("n", [1, 37, 4000, 4096])
def test_kernel_matches_plain_step_at_n(paths, n):
    """The G1-shaped fixture at N = 1 (one warp of a 4-warp block), 37, 4000
    (a ragged last block) and 4096 envs."""
    model, fc, params = _model(paths["g1"], True)
    fields, cmd = fx.random_sim_state(model, n, seed=19 + n, height=fx.G1_PELVIS_HEIGHT)
    state = SimState(**{k: torch.as_tensor(v, device="cuda") for k, v in fields.items()})
    cmd = torch.as_tensor(cmd, device="cuda")
    k_state, k_contact = cs.cuda_step(fc, params, state, cmd)
    assert k_contact.shape == (n, model.nb)
    p_contact = _assert_matches_plain(fc, params, state, cmd, k_state, k_contact)
    if n > 1:
        assert (p_contact > 0).any()


@pytest.mark.parametrize("instance", ["main", "per_env", "np", "np_per_env", "sharded",
                                      "wide", "wide_per_env"])
def test_two_launches_are_bitwise_equal(paths, instance):
    """Every sum across a warp's lanes runs in a fixed order (no atomics):
    two launches on one input block give the same bits, 4096 envs; ``wide``
    on the G1 with Dex3-1 hands."""
    n = 4096
    geoms = instance.startswith("np")
    model, fc, params = _model(paths["g1_dex3" if instance.startswith("wide") else "g1"], True)
    if geoms:
        model = attach_geoms(model, paths["g1"])
        fc = FusedModelConstants(model)
    if instance.endswith("per_env"):
        pe = fx.per_env_params(params.kp.cpu().numpy(), params.kv.cpu().numpy(), n, seed=20)
        params = dataclasses.replace(
            params, **{k: torch.as_tensor(v, device="cuda") for k, v in pe.items()})
    state, cmd = _bent(model, n, seed=21)
    if instance == "sharded":
        shard = EnvShard(n // 2, n, n)
        local = SimState(**{f: v[shard.slice] for f, v in state.__dict__.items()})

        def launch():
            st, contact = cs.sharded_cuda_step(fc, params, local, cmd[shard.slice], shard)
            return torch.cat([*(getattr(st, f) for f in fx.STATE_FIELDS), contact], dim=1)

        a, b = launch(), launch()
    else:
        np_ext = compute_np_ext(fc, params, params.ctrl_dt / params.substeps, state)
        inp = cs.pack_state(state, cmd, params, None, np_ext)
        a, b = (cs.launch_control_step(fc, params, inp) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_kernel_at_max_bodies(paths, tmp_path):
    """A model of 32 bodies (the G1-shaped fixture with two hinged hands),
    the narrow instance's most, and the G1 with Dex3-1 hands (44 bodies)
    through the wide instance launch and match the plain step; a model of
    49 bodies, past the wide instance's 48, is refused."""
    for path in (fx.write_wide_fixture(str(tmp_path), 2), paths["g1_dex3"],
                 fx.write_wide_fixture(str(tmp_path), 19)):
        model = build_physics_model(path)
        params = EngineParams(kp=torch.full((model.nd,), 50.0, device="cuda"),
                              kv=torch.full((model.nd,), 5.0, device="cuda"))
        fc = FusedModelConstants(model)
        fields, cmd = fx.random_sim_state(model, 1000, seed=22, height=fx.G1_PELVIS_HEIGHT)
        state = SimState(**{k: torch.as_tensor(v, device="cuda") for k, v in fields.items()})
        cmd = torch.as_tensor(cmd, device="cuda")
        if model.nb > 48:
            assert model.nb == 49
            with pytest.raises(ValueError, match="at most 48"):
                cs.cuda_step(fc, params, state, cmd)
            continue
        assert model.nb in (32, 44)
        wide = cs.cuda_step.wide_launches
        k_state, k_contact = cs.cuda_step(fc, params, state, cmd)
        assert cs.cuda_step.wide_launches == wide + (model.nb > 32)
        assert (_assert_matches_plain(fc, params, state, cmd, k_state, k_contact) > 0).any()


def _bent(model, n, seed):
    """Ground contact with the joints bent by 0.2 N(0, 1): the narrowphase
    pairs of the G1-shaped fixture push."""
    fields, cmd = fx.random_sim_state(model, n, seed=seed, height=fx.G1_PELVIS_HEIGHT)
    rng = np.random.default_rng(seed)
    fields["dof_pos"] = np.clip(fields["dof_pos"] + 0.2 * rng.normal(size=fields["dof_pos"].shape),
                                model.dof_limit[:, 0], model.dof_limit[:, 1]).astype(np.float32)
    state = SimState(**{k: torch.as_tensor(v, device="cuda") for k, v in fields.items()})
    return state, torch.as_tensor(cmd, device="cuda")


@pytest.mark.parametrize("which", ["g1", "g1_dex3"])
@pytest.mark.parametrize("per_env", [False, True], ids=["main", "per_env"])
def test_np_kernel_matches_plain_step(paths, per_env, which):
    """The kernel with its held narrowphase rows at 256 envs, main and
    per-env variant, against ``fused_step`` with the geom tables; on the G1
    with Dex3-1 hands through the wide instance."""
    model, fc, params = _model(paths[which], True)
    model = attach_geoms(model, paths[which])
    fc = FusedModelConstants(model)
    n = 256
    if per_env:
        pe = fx.per_env_params(params.kp.cpu().numpy(), params.kv.cpu().numpy(), n, seed=14)
        params = dataclasses.replace(
            params, **{k: torch.as_tensor(v, device="cuda") for k, v in pe.items()})
    state, cmd = _bent(model, n, seed=15)
    np_ext = compute_np_ext(fc, params, params.ctrl_dt / params.substeps, state)
    assert float(np_rows(np_ext).abs().max()) > 10.0
    before = (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.np_launches)
    k_state, k_contact = cs.cuda_step(fc, params, state, cmd)
    p_state, p_contact = fused_step(fc, params, state, cmd)
    torch.cuda.synchronize()
    want = (before[0] + (not per_env), before[1] + per_env, before[2] + 1)
    assert (cs.cuda_step.launches, cs.cuda_step.dr_launches, cs.cuda_step.np_launches) == want
    for f, tol in fx.step_tolerances().items():
        got = k_contact if f == "contact" else getattr(k_state, f)
        ref = p_contact if f == "contact" else getattr(p_state, f)
        torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"{f}: {m}")


def test_compute_np_ext_is_deterministic(paths):
    """Two ``compute_np_ext`` calls on the same input give the same bits:
    the per-body sums run in a fixed order, not through atomics."""
    model, _, params = _model(paths["g1"], True)
    model = attach_geoms(model, paths["g1"])
    fc = FusedModelConstants(model)
    state, _ = _bent(model, 1024, seed=16)
    dt = params.ctrl_dt / params.substeps
    a = np_rows(compute_np_ext(fc, params, dt, state))
    b = np_rows(compute_np_ext(fc, params, dt, state))
    assert float(a.abs().max()) > 10.0
    assert torch.equal(a, b)


def test_dr_train_iter_through_kernel(paths):
    """Two ``train_iter`` of ``dr_pod`` at 128 envs x 4 steps: every control
    step launches the per-env variant, losses are finite, parameters move."""
    n, steps = 128, 4
    cfg = load_config("dr_pod")
    cfg["robot"]["asset_path"] = paths["g1"]
    cfg["task"]["motion_file"] = paths["clip"]
    cfg["engine"]["num_envs"] = n
    cfg["agent"]["steps_per_iter"] = steps
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    env = build_env(cfg, device="cuda")
    assert env.kernel and env.dr.enabled
    agent = build_agent(cfg, env)
    ts = agent.init_train_state()
    g = torch.Generator(device="cuda").manual_seed(1)
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                         ts.sampler, generator=g)
    obs = env.compute_obs(es)
    p0 = [p.detach().clone() for p in ts.params.parameters()]
    before, before_dr = cs.cuda_step.launches, cs.cuda_step.dr_launches
    for _ in range(2):
        ts, es, obs, info = agent.train_iter(ts, es, obs, generator=g)
    torch.cuda.synchronize()
    assert (cs.cuda_step.launches, cs.cuda_step.dr_launches) == (before, before_dr + 2 * steps)
    assert all(bool(torch.isfinite(v).all()) for v in info.values())
    assert all(not torch.equal(a, b) for a, b in zip(p0, ts.params.parameters()))
    assert int(ts.sample_count) == 2 * steps * n


def test_launch_refuses_a_malformed_block(paths):
    model, fc, params = _model(paths["mini"], False)
    bad = torch.zeros((5, 8), device="cuda")
    with pytest.raises(ValueError, match="rows"):
        cs.launch_control_step(fc, params, bad)
    with pytest.raises(ValueError, match="contiguous f32"):
        cs.launch_control_step(fc, params, torch.zeros((13 + 4 * model.nd, 8), device="cuda").T)


def test_rollout_through_kernel_matches_plain_rollout(paths):
    """A 4-step f32 rollout at 32 envs: ``kernel: on`` against ``off``."""
    n, steps = 32, 4
    trajs = []
    for kernel in ("on", "off"):
        cfg = load_config("train")
        cfg["robot"]["asset_path"] = paths["g1"]
        cfg["task"]["motion_file"] = paths["clip"]
        cfg["engine"]["kernel"] = kernel
        cfg["agent"]["mixed_precision"] = False
        for k in ("actor_net", "critic_net", "disc_net"):
            cfg["agent"][k] = "fc_2layers_64units"
        env = build_env(cfg, device="cuda")
        assert env.kernel == (kernel == "on")
        agent = build_agent(cfg, env)
        ts = agent.init_train_state()
        g = torch.Generator(device="cuda").manual_seed(1)
        es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                             ts.sampler, generator=g)
        draws = agent.sample_rollout_draws(ts, n, steps, g)
        before = cs.cuda_step.launches
        _, obs, traj, _ = agent.rollout_lean(ts, es, env.compute_obs(es), steps, draws=draws)
        assert cs.cuda_step.launches - before == (steps if kernel == "on" else 0)
        assert torch.isfinite(obs).all()
        trajs.append(traj)
    for k in trajs[0]:
        torch.testing.assert_close(trajs[0][k].float(), trajs[1][k].float(), rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"{k}: {m}")


def test_dr_train_iter_through_kernel_matches_plain_step(paths):
    """One f32 ``train_iter`` of ``dr_pod`` at 64 envs x 4 steps through the
    per-env kernel and through the plain step, on the same draws and
    minibatch permutations: every info value within rtol = atol = 1e-2 (the
    update runs 40 Adam steps on data that differs by f32 op order)."""
    n, steps = 64, 4
    infos = []
    for kernel in ("on", "off"):
        cfg = load_config("dr_pod")
        cfg["robot"]["asset_path"] = paths["g1"]
        cfg["task"]["motion_file"] = paths["clip"]
        cfg["engine"]["num_envs"] = n
        cfg["engine"]["kernel"] = kernel
        cfg["agent"]["steps_per_iter"] = steps
        cfg["agent"]["mixed_precision"] = False
        for k in ("actor_net", "critic_net", "disc_net"):
            cfg["agent"][k] = "fc_2layers_64units"
        env = build_env(cfg, device="cuda")
        agent = build_agent(cfg, env)
        ts = agent.init_train_state()
        g = torch.Generator(device="cuda").manual_seed(3)
        es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                             ts.sampler, generator=g)
        g.manual_seed(4)
        draws = agent.sample_rollout_draws(ts, n, steps, g)
        g.manual_seed(5)                    # the same minibatch permutations
        before = cs.cuda_step.dr_launches
        info = agent.train_iter(ts, es, env.compute_obs(es), generator=g, draws=draws)[3]
        torch.cuda.synchronize()
        assert cs.cuda_step.dr_launches - before == (steps if kernel == "on" else 0)
        assert all(bool(torch.isfinite(v).all()) for v in info.values())
        infos.append(info)
    for k in infos[0]:
        torch.testing.assert_close(infos[0][k], infos[1][k], rtol=1e-2, atol=1e-2,
                                   msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("mode", ["amp", "none"])
def test_mode_train_iter_through_kernel_matches_plain_step(paths, mode):
    """One f32 ``train_iter`` of AMP (``agent=amp_g1``) and of plain PPO
    (``agent=ppo_g1``) at 64 envs x 4 steps through the main kernel and
    through the plain step, on the same draws, demo windows and minibatch
    permutations: every info value within rtol = atol = 1e-2, as the
    ``dr_pod`` case."""
    n, steps = 64, 4
    infos = []
    for kernel in ("on", "off"):
        cfg = load_config("train", [f"agent={dict(amp='amp_g1', none='ppo_g1')[mode]}"])
        cfg["robot"]["asset_path"] = paths["g1"]
        cfg["task"]["motion_file"] = paths["clip"]
        cfg["engine"]["num_envs"] = n
        cfg["engine"]["kernel"] = kernel
        cfg["agent"]["steps_per_iter"] = steps
        for k in ("actor_net", "critic_net", "disc_net"):
            cfg["agent"][k] = "fc_2layers_64units"
        env = build_env(cfg, device="cuda")
        agent = build_agent(cfg, env)
        assert agent.cfg.disc_mode == mode and not agent.cfg.mixed_precision
        ts = agent.init_train_state()
        g = torch.Generator(device="cuda").manual_seed(3)
        es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                             ts.sampler, generator=g)
        g.manual_seed(4)
        draws = agent.sample_rollout_draws(ts, n, steps, g)
        g.manual_seed(5)                    # the same demo windows and permutations
        before = cs.cuda_step.launches
        info = agent.train_iter(ts, es, env.compute_obs(es), generator=g, draws=draws)[3]
        torch.cuda.synchronize()
        assert cs.cuda_step.launches - before == (steps if kernel == "on" else 0)
        assert all(bool(torch.isfinite(v).all()) for v in info.values())
        assert ("disc_loss" in info) == (mode == "amp")
        infos.append(info)
    for k in infos[0]:
        torch.testing.assert_close(infos[0][k], infos[1][k], rtol=1e-2, atol=1e-2,
                                   msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("per_env", [False, True], ids=["main", "per_env"])
def test_sharded_kernel_matches_unsharded_bitwise(paths, per_env):
    """4096 envs of the G1-shaped fixture split into 2 and 4 shards: each
    shard's launch (global-size per-env leaves sliced to it) concatenated
    gives the unsharded kernel's bits, since one warp steps each env alone
    whatever the env count."""
    model, fc, params = _model(paths["g1"], True)
    n = 4096
    if per_env:
        pe = fx.per_env_params(params.kp.cpu().numpy(), params.kv.cpu().numpy(), n, seed=17)
        params = dataclasses.replace(
            params, **{k: torch.as_tensor(v, device="cuda") for k, v in pe.items()})
    fields, cmd = fx.random_sim_state(model, n, seed=18, height=fx.G1_PELVIS_HEIGHT)
    state = SimState(**{k: torch.as_tensor(v, device="cuda") for k, v in fields.items()})
    cmd = torch.as_tensor(cmd, device="cuda")
    whole, contact = cs.cuda_step(fc, params, state, cmd)
    for shards in (2, 4):
        k = n // shards
        before = cs.sharded_cuda_step.launches
        parts = [cs.sharded_cuda_step(
            fc, params, SimState(**{f: v[r * k:(r + 1) * k] for f, v in state.__dict__.items()}),
            cmd[r * k:(r + 1) * k], EnvShard(r * k, (r + 1) * k, n)) for r in range(shards)]
        torch.cuda.synchronize()
        assert cs.sharded_cuda_step.launches == before + shards
        for f in fx.STATE_FIELDS:
            assert torch.equal(torch.cat([getattr(p[0], f) for p in parts]), getattr(whole, f)), f
        assert torch.equal(torch.cat([p[1] for p in parts]), contact)


def test_trainer_save_resume_on_card(paths, tmp_path):
    """A one-rank ``Trainer`` on the card: 2 iterations at 128 envs, save,
    and a second ``Trainer`` resumes at iteration 2 with the same bits."""
    cfg = load_config("train")
    cfg["robot"]["asset_path"] = paths["g1"]
    cfg["task"]["motion_file"] = paths["clip"]
    cfg["engine"]["num_envs"] = 128
    cfg["agent"]["steps_per_iter"] = 4
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    cfg.update(device="cuda", test_episodes=0, log_dir=str(tmp_path), experiment_name="card")
    t1 = Trainer(cfg)
    assert t1.env.kernel
    t1.train(max_iters=2)
    t2 = Trainer(cfg)
    assert t2.iter == 2 and int(t2.ts.sample_count) == 2 * 4 * 128
    assert t2.ts.params.actor_mean.weight.is_cuda
    assert state_digest(t2.ts) == state_digest(t1.ts)
    t1.close(), t2.close()


@pytest.mark.parametrize("config", ["train", "dr_pod"])
def test_eval_rollout_states_through_kernel_matches_plain_step(paths, config):
    """8 steps of ``eval_rollout_states`` at 64 envs through the kernel (the
    main variant; the per-env one under ``dr_pod``) and through the plain
    step, from one state with the same reset draws: env 0's recorded states
    within rtol = atol = 1e-3, its motion ids equal."""
    n, steps = 64, 8
    outs = []
    for kernel in ("on", "off"):
        cfg = load_config(config)
        cfg["robot"]["asset_path"] = paths["g1"]
        cfg["task"]["motion_file"] = paths["clip"]
        cfg["engine"]["num_envs"] = n
        cfg["engine"]["kernel"] = kernel
        cfg["agent"]["mixed_precision"] = False
        for k in ("actor_net", "critic_net", "disc_net"):
            cfg["agent"][k] = "fc_2layers_64units"
        env = build_env(cfg, device="cuda")
        assert env.kernel == (kernel == "on") and env.dr.enabled == (config == "dr_pod")
        agent = build_agent(cfg, env)
        ts = agent.init_train_state()
        g = torch.Generator(device="cuda").manual_seed(1)
        es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                             ts.sampler, generator=g)
        draws = agent.sample_rollout_draws(ts, n, steps, g)
        counter = "dr_launches" if config == "dr_pod" else "launches"
        before = getattr(cs.cuda_step, counter)
        _, obs, states = agent.eval_rollout_states(ts, es, env.compute_obs(es), steps, draws=draws)
        torch.cuda.synchronize()
        assert getattr(cs.cuda_step, counter) - before == (steps if kernel == "on" else 0)
        assert torch.isfinite(obs).all() and states["root_pos"].shape == (steps, 3)
        outs.append(states)
    assert torch.equal(outs[0]["motion_id"], outs[1]["motion_id"])
    for k in ("root_pos", "root_quat", "dof_pos", "motion_time"):
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"{k}: {m}")


def test_forward_kinematics_on_card_matches_cpu(paths):
    from add_gym_torch.kinematics.char_model import load_char_model

    char = load_char_model(paths["g1"])
    rng = np.random.default_rng(12)
    q = rng.normal(size=(400, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    inputs = (rng.normal(0.0, 0.5, (400, 3)), q, rng.uniform(-1.5, 1.5, (400, char.dof_size)))
    outs = []
    for dev in ("cuda", "cpu"):
        rp, rq, dof = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in inputs)
        pos, rot = char.forward_kinematics(rp, rq, char.dof_to_rot(dof))
        assert pos.device.type == dev
        outs.append((pos.cpu(), rot.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_trainer_video_interval_on_card(paths, tmp_path):
    """A one-rank ``Trainer`` on the card with ``video_interval=1``: one
    iteration at 128 envs writes ``rollout_0000000.gif.npz`` after 4 + 400
    launches (the iteration's 4 steps, the 4-s video's 400); the GIF where
    PIL imports."""
    import importlib.util

    cfg = load_config("train")
    cfg["robot"]["asset_path"] = paths["mesh"]
    cfg["task"]["motion_file"] = paths["clip"]
    cfg["engine"]["num_envs"] = 128
    cfg["agent"]["steps_per_iter"] = 4
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    cfg.update(device="cuda", test_episodes=0, log_dir=str(tmp_path), experiment_name="video",
               iters_per_output=1, video_interval=1)
    t = Trainer(cfg)
    before = cs.cuda_step.launches
    t.train(max_iters=1)
    torch.cuda.synchronize()
    assert cs.cuda_step.launches - before == 4 + 400
    d = np.load(tmp_path / "video" / "rollout_0000000.gif.npz")
    assert d["body_pos"].shape == (400, 30, 3) and d["ghost_body_rot"].shape == (400, 30, 4)
    assert all(np.isfinite(d[k]).all() for k in ("body_pos", "body_rot", "ghost_body_pos"))
    if importlib.util.find_spec("PIL") is not None:
        assert (tmp_path / "video" / "rollout_0000000.gif").stat().st_size > 0
    t.close()


GRAPH_VARIANTS = dict(main=("train", [], "launches"),
                      per_env=("dr_pod", [], "dr_launches"),
                      np=("train", ["engine.general_narrowphase=true"], "np_launches"),
                      wide=("train", [], "wide_launches"),
                      wide_per_env=("dr_pod", [], "wide_launches"))


def _graph_case(paths, variant, n, steps):
    config, overrides, counter = GRAPH_VARIANTS[variant]
    cfg = load_config(config, overrides)
    cfg["robot"]["asset_path"] = paths["g1"]
    cfg["task"]["motion_file"] = paths["clip"]
    if variant.startswith("wide"):          # the G1 with Dex3-1 hands: 44 bodies
        cfg["robot"]["asset_path"] = paths["g1_dex3"]
        cfg["task"]["motion_file"] = paths["dex3_clip"]
        cfg["task"]["motion_joint_order"] = list(inputs.G1_DEX3_MOTION_JOINT_ORDER)
    cfg["engine"]["num_envs"] = n
    cfg["agent"]["steps_per_iter"] = steps
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    env = build_env(cfg, device="cuda")
    assert env.kernel
    agent = build_agent(cfg, env)
    ts = agent.init_train_state()
    g = torch.Generator(device="cuda").manual_seed(7)
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                         ts.sampler, generator=g)
    # every third env's episode ends within the first steps: the reset path runs
    last = cfg["task"]["max_episode_length"] - 0.025
    es = dataclasses.replace(es, time=torch.where(
        torch.arange(n, device="cuda") % 3 == 0, torch.full_like(es.time, last), es.time))
    draws = [agent.sample_rollout_draws(ts, n, steps, g) for _ in range(2)]
    return env, agent, ts, es, env.compute_obs(es), draws, counter


def _counts():
    f = imitation._step_counts
    return f.captures, f.replays, f.eager


@pytest.mark.parametrize("variant", sorted(GRAPH_VARIANTS))
def test_graphed_rollout_matches_eager_bitwise(paths, variant, monkeypatch):
    """Two chained ``rollout_lean`` of 8 steps at 64 envs, with forced
    resets, in the env's graph scope and with a null scope in its place, on
    the same draws: the main kernel variant (``train``), the per-env one
    with latency and mass (``dr_pod``), the narrowphase rows, and the wide
    instance in both variants on the G1 with Dex3-1 hands.  Every
    traj field, the final ``EnvState``, obs and obs statistics are equal
    bit for bit; the kernel's launch counter advances by the steps either
    way; the graph is captured once a rollout and replayed at every step;
    the memory the rollouts leave allocated is the eager rollouts' within
    1 MiB (the scope frees its buffers).  Each way runs one rollout first,
    so that what is made once a process or stream (a stream's cuBLAS
    workspace, which the narrowphase's matmuls take on the capture stream)
    is not counted; in the scope its first step is the env's warm-up step,
    run eagerly on the capture stream, and the graph is captured at its
    second, the launch counter advancing by the steps there too."""
    n, steps = 64, 8
    env, agent, ts, es, obs, draws, counter = _graph_case(paths, variant, n, steps)
    if variant == "np":
        assert len(env._fc.np_bodies)
    results, grown, first = {}, {}, {}
    for mode in ("eager", "graph"):
        if mode == "eager":
            monkeypatch.setattr(ImitationEnv, "graphed_steps",
                                lambda self: contextlib.nullcontext())
        else:
            monkeypatch.undo()
        counts0, launches0 = _counts(), getattr(cs.cuda_step, counter)
        first[mode] = agent.rollout_lean(ts, es, obs, steps, draws=draws[0])[2]
        assert getattr(cs.cuda_step, counter) - launches0 == steps, mode
        got = tuple(b - a for a, b in zip(counts0, _counts()))
        assert got == ((0, 0, steps) if mode == "eager" else (1, steps - 1, 1)), mode
        torch.cuda.synchronize()
        mem0, counts0, launches0 = (torch.cuda.memory_allocated(), _counts(),
                                    getattr(cs.cuda_step, counter))
        out = []
        state, o = es, obs
        for d in draws:
            state, o, traj, stats = agent.rollout_lean(ts, state, o, steps, draws=d)
            out.append((traj, stats))
        out.append((state, o))
        torch.cuda.synchronize()
        grown[mode] = torch.cuda.memory_allocated() - mem0
        assert getattr(cs.cuda_step, counter) - launches0 == 2 * steps, mode
        got = tuple(b - a for a, b in zip(counts0, _counts()))
        assert got == ((0, 0, 2 * steps) if mode == "eager" else (2, 2 * steps, 0)), mode
        results[mode] = out
    assert all(torch.equal(first["eager"][k], first["graph"][k]) for k in first["eager"])
    e, g = results["eager"], results["graph"]
    for (te, se), (tg, sg) in zip(e[:2], g[:2]):
        assert set(te) == set(tg)
        for k in te:
            assert torch.equal(te[k], tg[k]), k
        for a, b in zip(se, sg):
            assert torch.equal(a, b)
    assert int((e[0][0]["done"] != 0).sum()) >= n // 3
    assert all(torch.equal(a, b) for a, b in zip(imitation._leaves(e[2][0]),
                                                  imitation._leaves(g[2][0])))
    assert torch.equal(e[2][1], g[2][1])
    assert abs(grown["graph"] - grown["eager"]) <= 2**20, grown


@pytest.mark.parametrize("config", ["train", "dr_pod"])
def test_traced_train_iter_spans_on_card(paths, config):
    """One traced ``train_iter`` at 64 envs x 4 steps (after an untraced
    one): no device-typed event of the trace carries the name of a program
    span or of the anchor (``utils.trace``), the spans mapped through the
    anchor hold the 4 control steps, one ``env.capture`` (the env step's
    graph, captured under the profiler) and 4 ``env.graph`` spans, and the
    launch row of every ``agt_control_step`` kernel (the graph's launch)
    lies inside an ``env.graph`` span."""
    n, steps = 64, 4
    cfg = load_config(config)
    cfg["robot"]["asset_path"] = paths["g1"]
    cfg["task"]["motion_file"] = paths["clip"]
    cfg["engine"]["num_envs"] = n
    cfg["agent"]["steps_per_iter"] = steps
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    env = build_env(cfg, device="cuda")
    assert env.kernel
    agent = build_agent(cfg, env)
    ts = agent.init_train_state()
    g = torch.Generator(device="cuda").manual_seed(1)
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool, device="cuda"),
                         ts.sampler, generator=g)
    ts, es, obs, _ = agent.train_iter(ts, es, env.compute_obs(es), generator=g)
    torch.cuda.synchronize()
    trace.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        agent.train_iter(ts, es, obs, generator=g)
        torch.cuda.synchronize()
    records = trace.take()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
    assert not {r[0] for r in records} & {e.name() for e in device}
    placed = trace.place(records, [(e.start_ns(), e.end_ns()) for e in host
                                   if e.name() == trace.ANCHOR])
    assert sum(r[0] == "rollout.step" for r in placed) == steps
    assert sum(r[0] == "env.capture" for r in placed) == 1
    graphs = [(s, e) for name, s, e, _, _ in placed if name == "env.graph"]
    assert len(graphs) == steps
    kernels = [e for e in device if "agt_control_step" in e.name()]
    assert len(kernels) == steps
    launches = {e.correlation_id(): e for e in host if e.name().startswith(("cuda", "cu"))}
    for k in kernels:
        launch = launches.get(k.correlation_id()) or launches.get(k.linked_correlation_id())
        assert launch is not None, (k.name(), k.correlation_id(), k.linked_correlation_id())
        assert any(s <= launch.start_ns() and launch.end_ns() <= e for s, e in graphs), \
            (launch.name(), launch.start_ns(), graphs)
