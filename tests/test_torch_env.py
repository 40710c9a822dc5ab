"""Port parity: observations, reward, done and the imitation env.

Function level: ``compute_add_obs`` / ``compute_disc_obs``,
``compute_reward`` and ``compute_done`` on the same random inputs (global
and heading-local variants).  Env level, on the mini biped (N=8, fast to
compile): ``reset_where`` with the JAX package's injected draws,
``compute_obs``, ``motion_aux`` and one ``rollout_step_cached`` in which
some envs finish and reset.

Tolerances: the obs and reward are f32 compositions of rotation functions
(atol = 1e-5); ``done`` flags and motion ids are compared exactly; the
physics step inside ``rollout_step_cached`` is held to
``physics.testing.step_tolerances()`` and what derives from it to 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.envs import obs as jobs
from add_gym_tpu.envs.done import compute_done as jax_done
from add_gym_tpu.envs.domain_rand import init_dr_state as jax_dr
from add_gym_tpu.envs.reward import compute_reward as jax_reward
from add_gym_tpu.learning.sampler import init_sampler as jax_init_sampler
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_env
from add_gym_torch.envs import obs as tobs
from add_gym_torch.envs.done import DoneFlags, compute_done
from add_gym_torch.envs.domain_rand import init_dr_state
from add_gym_torch.envs.reward import compute_reward
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N = 8


def _quat(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("global_obs", [True, False])
def test_obs_functions_match(global_obs):
    rng = np.random.default_rng(0)
    D, K, H = 5, 6, 3
    args = [
        rng.normal(size=(N, 3)).astype(np.float32), _quat(rng, (N,)),
        rng.normal(size=(N, 3)).astype(np.float32), rng.normal(size=(N, 3)).astype(np.float32),
        rng.normal(size=(N, D)).astype(np.float32), rng.normal(size=(N, D)).astype(np.float32),
        rng.uniform(size=(N,)).astype(np.float32),
        rng.normal(size=(N, K, 3)).astype(np.float32), _quat(rng, (N, K)),
        rng.normal(size=(N, K, D)).astype(np.float32),
    ]
    ja, ta = _both(*args)
    for vel, phase, height in ((False, False, True), (True, True, False)):
        kw = dict(enable_vel_obs=vel, global_obs=global_obs, root_height_obs=height,
                  enable_phase_obs=phase, num_phase_encoding=4, enable_tar_obs=True)
        want = jobs.compute_add_obs(*ja, **kw)
        got = tobs.compute_add_obs(*ta, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    hist = [rng.normal(size=(N, H, 3)).astype(np.float32), _quat(rng, (N, H)),
            rng.normal(size=(N, H, 3)).astype(np.float32), rng.normal(size=(N, H, 3)).astype(np.float32),
            rng.normal(size=(N, H, D)).astype(np.float32), rng.normal(size=(N, H, D)).astype(np.float32)]
    jh, th = _both(*hist)
    for vel in (False, True):
        want = jobs.compute_disc_obs(*jh, enable_vel_obs=vel, global_obs=global_obs)
        got = tobs.compute_disc_obs(*th, enable_vel_obs=vel, global_obs=global_obs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("track_root", [True, False])
def test_reward_matches(track_root):
    rng = np.random.default_rng(1)
    D = 7
    sim = [rng.normal(size=(N, 3)), _quat(rng, (N,)), rng.normal(size=(N, 3)),
           rng.normal(size=(N, 3)), rng.normal(size=(N, D)), rng.normal(size=(N, D))]
    ref = [rng.normal(size=(N, 3)), _quat(rng, (N,)), rng.normal(size=(N, 3)),
           rng.normal(size=(N, 3)), rng.normal(size=(N, D)), rng.normal(size=(N, D))]
    arrays = [np.asarray(a, np.float32) for a in sim + ref] + [np.ones(D, np.float32)]
    ja, ta = _both(*arrays)
    kw = dict(track_root_h=not track_root, track_root=track_root, pose_w=0.5, vel_w=0.1,
              root_pose_w=0.15, root_vel_w=0.1, pose_scale=0.25, vel_scale=0.01,
              root_pose_scale=5.0, root_vel_scale=1.0)
    np.testing.assert_allclose(compute_reward(*ta, **kw).numpy(),
                               np.asarray(jax_reward(*ja, **kw)), atol=1e-6)


def test_done_matches():
    rng = np.random.default_rng(2)
    nb, D, n = 6, 5, 64
    time = rng.choice([0.0, 0.5, 19.995, 20.0], n).astype(np.float32)
    root_pos = rng.normal(size=(n, 3)).astype(np.float32)
    dof = rng.normal(size=(n, D)).astype(np.float32)
    tar_root = (root_pos + rng.normal(0, 0.7, (n, 3))).astype(np.float32)
    tar_dof = (dof + rng.normal(0, 1.0, (n, D))).astype(np.float32)
    contact = np.where(rng.uniform(size=(n, nb)) < 0.1, 5.0, 0.0).astype(np.float32)
    mt = rng.uniform(0, 3, n).astype(np.float32)
    mlen = np.full(n, 2.0, np.float32)
    term = rng.uniform(size=n) < 0.5
    mask = np.array([True, False, True, False, False, True])
    for early, pose, track in ((True, True, True), (True, True, False), (True, False, True),
                               (False, True, True)):
        kw = dict(ep_len=20.0, pose_termination=pose, pose_termination_dist=1.0,
                  enable_early_termination=early, track_root=track)
        want = jax_done(*[jnp.asarray(a) for a in (time, root_pos, dof, tar_root, tar_dof,
                                                   contact, mt, mlen, term)],
                        noncontact_body_mask=mask, **kw)
        got = compute_done(*[torch.as_tensor(a) for a in (time, root_pos, dof, tar_root, tar_dof,
                                                           contact, mt, mlen, term)],
                           noncontact_body_mask=torch.as_tensor(mask), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {int(f) for f in DoneFlags}


# ------------------------------------------------------------- env level

MINI_JOINTS = ["left_leg_joint", "right_leg_joint"]


def _cfg(load, mjcf, clip):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["robot"]["joints"] = [{"match": ".*leg_joint", "tags": ["hip"]}]
    cfg["task"]["motion_file"] = clip
    cfg["task"]["motion_joint_order"] = MINI_JOINTS
    cfg["task"]["contact_bodies"] = ["left_leg_link", "right_leg_link"]
    cfg["engine"]["num_envs"] = N
    return cfg


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    d = tmp_path_factory.mktemp("env")
    mjcf = fx.write_mini_mjcf(str(d))
    clip = fx.write_motion_csv(str(d / "mini.motion"), seed=3, num_frames=90,
                               joint_order=MINI_JOINTS, height=0.65)
    jenv = jax_build_env(_cfg(jax_load_config, mjcf, clip))
    tenv = build_env(_cfg(load_config, mjcf, clip), device="cpu")
    assert not tenv.kernel                 # kernel "auto" on the CPU: the plain step
    return jenv, tenv


def _cmp_env_state(t, j, tol=1e-4):
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(t.sim, f).numpy(), np.asarray(getattr(j.sim, f)),
                                   rtol=tol, atol=tol, err_msg=f)
    for f in ("time", "motion_offsets", "hist_root_pos", "hist_root_rot", "hist_root_vel",
              "hist_root_ang_vel", "hist_dof_pos", "hist_dof_vel"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_array_equal(t.motion_ids.numpy(), np.asarray(j.motion_ids))
    np.testing.assert_array_equal(t.done.numpy(), np.asarray(j.done))


def _reset_pair(jenv, tenv):
    sampler = jax_init_sampler(1, jenv.task.sampler_num_segments)
    key = jax.random.PRNGKey(0)
    mask = np.array([True] * 6 + [False] * 2)
    jes = jenv.reset_where(key, jenv.init_state(N), jnp.asarray(mask), sampler)
    k1, k2, _ = jax.random.split(key, 3)
    ids = jenv.motion.sample_motions(k1, N)
    times = jenv._sample_times(k2, ids, sampler)
    tes = tenv.reset_where(tenv.init_state(N), torch.as_tensor(mask), None,
                           draws=(np.asarray(ids), np.asarray(times)))
    return jes, tes


def test_reset_where_and_compute_obs_match(envs):
    jenv, tenv = envs
    assert (jenv.obs_dim(), jenv.disc_obs_dim()) == (tenv.obs_dim(), tenv.disc_obs_dim())
    jes, tes = _reset_pair(jenv, tenv)
    _cmp_env_state(tes, jes, tol=1e-6)
    np.testing.assert_allclose(tenv.compute_obs(tes).numpy(), np.asarray(jenv.compute_obs(jes)),
                               atol=1e-5)
    np.testing.assert_allclose(tenv.motion_aux(tes).numpy(), np.asarray(jenv.motion_aux(jes)),
                               atol=1e-6)
    np.testing.assert_allclose(
        tenv._disc_obs_demo(tes.motion_ids, tenv.motion_times(tes)).numpy(),
        np.asarray(jenv._disc_obs_demo(jes.motion_ids, jenv.motion_times(jes))), atol=1e-5)


def test_rollout_step_cached_matches(envs):
    jenv, tenv = envs
    jes, tes = _reset_pair(jenv, tenv)
    # two episodes run out of time on this step, so the masked reset runs
    ep_time = np.zeros(N, np.float32)
    ep_time[[1, 6]] = jenv.task.max_episode_length - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    rng = np.random.default_rng(4)
    action = rng.normal(0.0, 0.3, (N, 2)).astype(np.float32)
    ids_f = np.zeros(N, np.int32)
    times_f = (np.round(rng.uniform(0.05, 2.0, N) / 0.01) * 0.01).astype(np.float32)

    jaux = jenv.motion_aux(jes)
    j3, jobs_after, jaux3, jout = jax.jit(jenv.rollout_step_cached)(
        jes, jnp.asarray(action), jaux, jnp.asarray(ids_f), jnp.asarray(times_f), jax_dr(N))
    taux = tenv.motion_aux(tes)
    t3, tobs_after, taux3, tout = tenv.rollout_step_cached(
        tes, torch.as_tensor(action), taux, torch.as_tensor(ids_f, dtype=torch.int64),
        torch.as_tensor(times_f), init_dr_state(N))

    assert (np.asarray(jout["done"])[[1, 6]] != 0).all()
    _cmp_env_state(t3, j3)
    np.testing.assert_allclose(tobs_after.numpy(), np.asarray(jobs_after), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(taux3.numpy(), np.asarray(jaux3), rtol=1e-4, atol=1e-4)
    assert set(tout) == set(jout)
    _cmp_out(tout, jout)


def _cmp_out(tout, jout, tol=1e-4):
    for k in jout:
        a, b = np.asarray(jout[k]), tout[k].numpy()
        if k in ("done", "motion_ids"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=k)


def test_rollout_with_sparse_tar_obs_steps_matches(tmp_path):
    """``tar_obs_steps = (1, 3, 5)`` has no incremental row window: the
    port's ``rollout_step_cached`` composes ``step``, ``reset_where`` and
    ``compute_obs`` on its presampled draws.  Three chained steps against
    JAX ``rollout_step`` (its plain branch), fed the draws JAX's
    ``reset_where`` takes from each step's key; two episodes reset on the
    first step."""
    mjcf = fx.write_mini_mjcf(str(tmp_path))
    clip = fx.write_motion_csv(str(tmp_path / "mini.motion"), seed=3, num_frames=90,
                               joint_order=MINI_JOINTS, height=0.65)
    envs_ = []
    for load in (jax_load_config, load_config):
        cfg = _cfg(load, mjcf, clip)
        cfg["task"]["tar_obs_steps"] = [1, 3, 5]
        envs_.append(cfg)
    jenv = jax_build_env(envs_[0])
    tenv = build_env(envs_[1], device="cpu")
    assert not jenv._aux_shiftable and not tenv._aux_shiftable
    assert tenv.obs_dim() == jenv.obs_dim()
    jes, tes = _reset_pair(jenv, tenv)
    ep_time = np.zeros(N, np.float32)
    ep_time[[0, 5]] = jenv.task.max_episode_length - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    sampler = jax_init_sampler(1, jenv.task.sampler_num_segments)
    rng = np.random.default_rng(5)
    jstep = jax.jit(jenv.rollout_step)
    aux = tenv.motion_aux(tes)
    for t in range(3):
        key = jax.random.PRNGKey(10 + t)
        action = rng.normal(0.0, 0.3, (N, 2)).astype(np.float32)
        jes, jobs_after, jout = jstep(key, jes, jnp.asarray(action), sampler)
        k1, k2, _ = jax.random.split(key, 3)
        ids = jenv.motion.sample_motions(k1, N)
        times = jenv._sample_times(k2, ids, sampler)
        tes, tobs_after, aux, tout = tenv.rollout_step_cached(
            tes, torch.as_tensor(action), aux, torch.as_tensor(np.array(ids), dtype=torch.int64),
            torch.as_tensor(np.array(times)), init_dr_state(N))
        assert aux is None
        if t == 0:
            assert (np.asarray(jout["done"])[[0, 5]] != 0).all()
        _cmp_env_state(tes, jes)
        np.testing.assert_allclose(tobs_after.numpy(), np.asarray(jobs_after), rtol=1e-4,
                                   atol=1e-4)
        assert set(tout) == set(jout)
        _cmp_out(tout, jout)


def test_env_device_and_backend_selection(envs, tmp_path):
    """``ImitationEnv`` defaults to the card and raises where there is none;
    ``engine.fused: false`` steps through the reference-layout engine, and
    the kernel cannot be that backend."""
    from add_gym_torch.envs.imitation import ImitationEnv

    _, tenv = envs
    args = (tenv.model, tenv.motion, tenv.params, tenv.task)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImitationEnv(*args)
    with pytest.raises(ValueError, match="kernel needs fused=True"):
        ImitationEnv(*args, kernel=True, fused=False, device="cpu")

    mjcf = fx.write_mini_mjcf(str(tmp_path))
    clip = fx.write_motion_csv(str(tmp_path / "mini.motion"), seed=3, num_frames=90,
                               joint_order=MINI_JOINTS, height=0.65)
    cfg = _cfg(load_config, mjcf, clip)
    cfg["engine"]["fused"] = False
    ref_env = build_env(cfg, device="cpu")
    assert not ref_env.fused and not ref_env.kernel
    cfg["engine"]["kernel"] = "on"
    with pytest.raises(ValueError, match="kernel needs fused=True"):
        build_env(cfg, device="cpu")
    # the reference-layout env and the plain-step env take the same step
    _, tes = _reset_pair(envs[0], tenv)
    tgt = torch.as_tensor(np.random.default_rng(6).normal(0.0, 0.3, (N, 2)), dtype=torch.float32)
    a, b = ref_env.step(tes, tgt), tenv.step(tes, tgt)
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(a[0].sim, f).numpy(), getattr(b[0].sim, f).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(a[-1].numpy(), b[-1].numpy())
