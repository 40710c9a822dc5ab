"""Port parity with general geom-geom narrowphase on: the env and training.

Both packages are built from config ``train`` with
``engine.general_narrowphase: true`` on the G1-shaped fixture (637 pairs
over 30 bodies) and a synthetic clip, N=8 envs, ``fc_2layers_64units``
nets, f32.  (A file of its own, apart from ``test_torch_env.py`` and
``test_torch_train.py``, so that its JAX compiles run beside theirs.)

* ``build_env`` attaches the same geom tables as the JAX builder, and
  ``env.step`` from a reset state with the joints bent by 0.2 N(0, 1)
  (active pairs) matches JAX ``env.step`` over 3 chained steps: state,
  obs, disc obs, reward at rtol = atol = 1e-4 (the stiff narrowphase
  springs turn f32 op-order differences of ~1e-6 into ~1e-5 over the
  steps), done flags exactly.
* One ``train_iter`` (T=4, two minibatches of 16, five epochs) chained from
  the JAX state with the JAX package's draws and permutations: infos at
  1e-4, parameters within the lr-unit tolerance of ``test_torch_train.py``
  (2 lr, 99% within 0.05 lr).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.learning.convert import _flax_like_params, from_jax
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.fused_step import compute_np_ext, np_rows
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 8, 4
LR = 1e-4
TOL = 1e-4
GEOM_FIELDS = ("seg_body", "seg_p0", "seg_p1", "seg_radius", "box_body", "box_pos", "box_rot",
               "box_half", "ss_pairs", "ss_mass", "sb_pairs", "sb_mass", "bb_pairs", "bb_mass")


def _cfg(load, mjcf, clip):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["task"]["motion_file"] = clip
    cfg["engine"]["num_envs"] = N
    cfg["engine"]["general_narrowphase"] = True
    cfg["agent"]["steps_per_iter"] = T
    cfg["agent"]["batch_size"] = 2
    cfg["agent"]["mixed_precision"] = False
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = "fc_2layers_64units"
    return cfg


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("np_train")
    mjcf = fx.write_g1_fixture(str(d))
    clip = fx.write_motion_csv(str(d / "clip.motion"), seed=5, num_frames=120)
    jcfg = _cfg(jax_load_config, mjcf, clip)
    jenv = jax_build_env(jcfg)
    tenv = build_env(_cfg(load_config, mjcf, clip), device="cpu")
    return dict(jcfg=jcfg, jenv=jenv, tenv=tenv, jagent=jax_build_agent(jcfg, jenv),
                tagent=build_agent(_cfg(load_config, mjcf, clip), tenv))


def _start(pair, seed):
    """Reset states of both packages on JAX's draws, two of them one step
    from their time limit and every joint bent by 0.2 N(0, 1)."""
    jenv, tenv = pair["jenv"], pair["tenv"]
    jts = pair["jagent"].init_train_state(jax.random.PRNGKey(7))
    key0 = jax.random.PRNGKey(seed)
    jes = jenv.reset_where(key0, jenv.init_state(N), jnp.ones(N, bool), jts.sampler)
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, N)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)
    tts = from_jax(pair["tagent"], jts)
    tes = tenv.reset_where(tenv.init_state(N), torch.ones(N, dtype=torch.bool), tts.sampler,
                           draws=(np.asarray(r_ids), np.asarray(r_times)))

    rng = np.random.default_rng(seed)
    lim = tenv.model.dof_limit
    dof = np.clip(np.asarray(jes.sim.dof_pos) + 0.2 * rng.normal(size=(N, tenv.model.nd)),
                  lim[:, 0], lim[:, 1]).astype(np.float32)
    ep_time = np.zeros(N, np.float32)
    ep_time[:2] = pair["jcfg"]["task"]["max_episode_length"] - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time),
                              sim=dataclasses.replace(jes.sim, dof_pos=jnp.asarray(dof)))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time),
                              sim=dataclasses.replace(tes.sim, dof_pos=torch.as_tensor(dof)))
    return jts, jes, tts, tes


def test_build_env_attaches_the_jax_geom_tables(pair):
    jenv, tenv = pair["jenv"], pair["tenv"]
    assert tenv.fused and not tenv.kernel
    assert tenv.model.geoms.num_pairs == jenv.model.geoms.num_pairs == 637
    for name in GEOM_FIELDS:
        np.testing.assert_array_equal(getattr(tenv.model.geoms, name),
                                      getattr(jenv.model.geoms, name), err_msg=name)
    assert len(tenv._fc.np_bodies) == tenv.model.nb


def test_env_step_with_geoms_matches_jax(pair):
    jenv, tenv = pair["jenv"], pair["tenv"]
    _, jes, _, tes = _start(pair, seed=0)
    params = tenv.params
    np_ext = compute_np_ext(tenv._fc, params, params.ctrl_dt / params.substeps, tes.sim)
    assert float(np_rows(np_ext).abs().max()) > 10.0          # pairs push
    rng = np.random.default_rng(1)
    jstep = jax.jit(jenv.step)
    names = ("obs", "disc_obs", "disc_obs_demo", "reward")
    for t in range(3):
        tgt = (np.asarray(tes.sim.dof_pos) + rng.normal(0.0, 0.1, (N, tenv.model.nd))
               ).astype(np.float32)
        jes, *jrest = jstep(jes, jnp.asarray(tgt))
        tes, *trest = tenv.step(tes, torch.as_tensor(tgt))
        for f in fx.STATE_FIELDS:
            np.testing.assert_allclose(getattr(tes.sim, f).numpy(),
                                       np.asarray(getattr(jes.sim, f)),
                                       rtol=TOL, atol=TOL, err_msg=f"step {t}: {f}")
        for name, a, b in zip(names, trest, jrest):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                                       err_msg=f"step {t}: {name}")
        np.testing.assert_array_equal(trest[-1].numpy(), np.asarray(jrest[-1]))
        if t == 0:
            assert (np.asarray(jrest[-1])[:2] != 0).all()      # time limits


def _assert_params_close(net, jax_params, bulk=0.05):
    want = _flax_like_params(net, jax_params)
    diffs = np.concatenate([(p.detach() - w).abs().flatten().numpy()
                            for p, w in zip(net.parameters(), want)])
    assert diffs.max() <= 2 * LR, f"max |delta| {diffs.max() / LR:.3f} lr"
    assert np.mean(diffs > bulk * LR) <= 0.01


def test_train_iter_with_geoms_matches_jax(pair):
    jenv, jagent, tagent = pair["jenv"], pair["jagent"], pair["tagent"]
    jts, jes, tts, tes = _start(pair, seed=2)
    jobs, tobs = jenv.compute_obs(jes), pair["tenv"].compute_obs(tes)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-5)

    key = jax.random.PRNGKey(9)
    k_roll, _, k_upd = jax.random.split(key, 3)
    k_noise, k_bern, k_ids, k_times, _ = jax.random.split(k_roll, 5)
    noise = jax.random.normal(k_noise, (T, N, jenv.num_dofs))
    bern = jax.random.bernoulli(k_bern, jagent._exp_prob(jts.sample_count), (T, N, 1))
    ids_f = jenv.motion.sample_motions(k_ids, T * N)
    times_f = jenv._sample_times(k_times, ids_f, jts.sampler).reshape(T, N)
    draws = tuple(np.asarray(x, np.float32 if x.dtype == bool else x.dtype)
                  for x in (noise, bern, ids_f.reshape(T, N), times_f))
    perms = [np.asarray(jax.random.permutation(k, 4))
             for k in jax.random.split(k_upd, tagent.cfg.update_epochs)]

    jts2, jes2, jobs2, jinfo = jagent.train_iter(jts, jes, jobs, key)
    tts2, tes2, tobs2, tinfo = tagent.train_iter(tts, tes, tobs, draws=draws, perms=perms)

    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert float(jinfo["done_frac"]) > 0.0
    _assert_params_close(tts2.params, jts2.params)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=TOL, atol=TOL)
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(tes2.sim, f).numpy(), np.asarray(getattr(jes2.sim, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(tes2.motion_ids.numpy(), np.asarray(jes2.motion_ids))
