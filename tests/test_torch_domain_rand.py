"""Port parity: domain randomization.

Both packages run the ``domain_rand`` block of the port's ``dr_pod`` config
(gains, friction, latency, mass) with ``mass_range`` widened to [0.5, 2.0],
as tests/test_domain_rand.py does, so the mass scale matters; the JAX side
gets it on its ``train`` config (its ``dr_pod`` sets up a device mesh).
Fixture: the G1-shaped MJCF and a synthetic clip, N=8 envs, T=4 steps,
64-unit nets, f32.

* ``sample_dr``: draws within the ranges, log-uniform where JAX draws
  log-uniform (quantiles of 20,000 draws against the JAX package's within
  0.02), and the same function of its uniforms (1e-6).
* ``_effective_params``: the per-env gains, friction and mass scale equal
  the JAX package's (1e-6).
* The latency blend and the per-env physics: one ``rollout_step_cached``
  with the same draws, against JAX, within the one-step tolerances
  (``physics.testing.step_tolerances``).
* ``reset_where`` draws the perturbations anew for the masked envs only.
* ``rollout_lean`` with domain randomization against JAX, with the JAX
  draws (``dr_f`` included) injected: rtol = atol = 1e-4, as the plain
  rollout's test holds it (tests/test_torch_rollout.py).
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.envs.domain_rand import sample_dr as jax_sample_dr
from add_gym_tpu.learning.sampler import init_sampler as jax_init_sampler
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.envs.domain_rand import DR_KEYS, DRConfig, sample_dr
from add_gym_torch.learning.convert import from_jax
from add_gym_torch.learning.sampler import init_sampler
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 8, 4
SMALL_NET = "fc_2layers_64units"
MASS_RANGE = [0.5, 2.0]


def _dr_block():
    dr = dict(load_config("dr_pod")["engine"]["domain_rand"])
    dr["mass_range"] = MASS_RANGE
    return dr


def _cfg(cfg, mjcf, clip):
    cfg["robot"]["asset_path"] = mjcf
    cfg["task"]["motion_file"] = clip
    cfg["engine"]["num_envs"] = N
    cfg["engine"]["domain_rand"] = _dr_block()
    cfg["agent"]["steps_per_iter"] = T
    cfg["agent"]["mixed_precision"] = False
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = SMALL_NET
    return cfg


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dr")
    mjcf = fx.write_g1_fixture(str(d))
    clip = fx.write_motion_csv(str(d / "clip.motion"), seed=5, num_frames=120)
    jcfg = _cfg(jax_load_config("train"), mjcf, clip)
    tcfg = _cfg(load_config("dr_pod"), mjcf, clip)
    jenv = jax_build_env(jcfg)
    tenv = build_env(tcfg, device="cpu")
    assert jenv.dr.enabled and tenv.dr.enabled and tenv.dr.mass_enabled
    return dict(jcfg=jcfg, tcfg=tcfg, jenv=jenv, tenv=tenv)


def _np_dr(seed, n=N):
    """Per-env perturbations from a numpy seed, inside the config ranges."""
    rng = np.random.default_rng(seed)
    b = _dr_block()
    return dict(
        kp_scale=rng.uniform(*b["kp_scale_range"], n),
        kv_scale=rng.uniform(*b["kv_scale_range"], n),
        friction_mu=rng.uniform(*b["friction_range"], n),
        latency=rng.uniform(*b["action_latency_range"], n),
        mass_scale=rng.uniform(*MASS_RANGE, n),
    )


def _with_dr(jstate, tstate, dr):
    jstate = dataclasses.replace(jstate, dr={k: jnp.asarray(v, jnp.float32) for k, v in dr.items()})
    tstate = dataclasses.replace(tstate, dr={k: torch.as_tensor(v, dtype=torch.float32)
                                             for k, v in dr.items()})
    return jstate, tstate


# --------------------------------------------------------------- sample_dr


def test_sample_dr_ranges_and_distribution(envs):
    cfg = envs["tenv"].dr
    n = 20000
    got = sample_dr(cfg, n, torch.Generator().manual_seed(0))
    want = jax_sample_dr(jax.random.PRNGKey(0), envs["jenv"].dr, n)
    ranges = dict(kp_scale=cfg.kp_scale_range, kv_scale=cfg.kv_scale_range,
                  friction_mu=cfg.friction_range, latency=cfg.action_latency_range,
                  mass_scale=cfg.mass_range)
    qs = np.linspace(0.05, 0.95, 19)
    for k in DR_KEYS:
        x = got[k].numpy()
        lo, hi = ranges[k]
        assert x.shape == (n,) and (x >= lo).all() and (x <= hi).all(), k
        np.testing.assert_allclose(np.quantile(x, qs), np.quantile(np.asarray(want[k]), qs),
                                   atol=0.02, err_msg=k)
    # log-uniform: the log of the mass scale is uniform between the logs
    np.testing.assert_allclose(np.log(got["mass_scale"].numpy()).mean(),
                               0.5 * (np.log(0.5) + np.log(2.0)), atol=0.02)


def test_sample_dr_is_the_jax_map_of_its_uniforms(envs):
    """The same map from uniforms to perturbations as JAX's
    ``uniform(minval=log lo, maxval=log hi)``, on the uniforms the
    generator draws."""
    cfg = envs["tenv"].dr
    got = sample_dr(cfg, 64, torch.Generator().manual_seed(1))
    u = torch.rand((len(DR_KEYS), 64), generator=torch.Generator().manual_seed(1)).numpy()

    def logu(row, lo, hi):
        return np.exp(np.float32(np.log(lo)) + u[row] * np.float32(np.log(hi) - np.log(lo)))

    want = dict(
        kp_scale=logu(0, *cfg.kp_scale_range), kv_scale=logu(1, *cfg.kv_scale_range),
        friction_mu=logu(2, *cfg.friction_range),
        latency=cfg.action_latency_range[0]
        + u[3] * (cfg.action_latency_range[1] - cfg.action_latency_range[0]),
        mass_scale=logu(4, *cfg.mass_range),
    )
    for k in DR_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_sample_dr_off_is_the_identity(envs):
    env = copy.copy(envs["tenv"])
    env.dr = DRConfig()
    dr = env.sample_dr(5, torch.Generator().manual_seed(0))
    for k in DR_KEYS:
        assert torch.equal(dr[k], torch.zeros(5) if k == "latency" else torch.ones(5)), k


# ------------------------------------------------------- effective params


@pytest.mark.parametrize("mass", [True, False], ids=["mass", "no_mass"])
def test_effective_params_match_jax(envs, mass):
    jenv, tenv = envs["jenv"], envs["tenv"]
    if not mass:
        jenv, tenv = copy.copy(jenv), copy.copy(tenv)
        jenv.dr = dataclasses.replace(jenv.dr, mass_range=(1.0, 1.0))
        tenv.dr = dataclasses.replace(tenv.dr, mass_range=(1.0, 1.0))
    js, ts = _with_dr(jenv.init_state(N), tenv.init_state(N), _np_dr(2))
    jp, tp = jenv._effective_params(js), tenv._effective_params(ts)
    assert tuple(tp.kp.shape) == tuple(tp.kv.shape) == (N, tenv.num_dofs)
    for f in ("kp", "kv", "friction_mu"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    if mass:
        np.testing.assert_allclose(tp.mass_scale.numpy(), np.asarray(jp.mass_scale), rtol=1e-6)
    else:
        assert tp.mass_scale == jp.mass_scale == 1.0


# -------------------------------------------- latency blend and one step


def _reset_pair(envs, key, dr):
    """JAX and port env states reset with the same draws (the JAX ones)."""
    jenv, tenv = envs["jenv"], envs["tenv"]
    jsampler = jax_init_sampler(jenv.motion.num_motions, jenv.task.sampler_num_segments)
    k1, k2, _ = jax.random.split(key, 3)
    ids = jenv.motion.sample_motions(k1, N)
    times = jenv._sample_times(k2, ids, jsampler)
    js = jenv.reset_where(key, jenv.init_state(N), jnp.ones(N, bool), jsampler)
    js = dataclasses.replace(js, dr={k: jnp.asarray(v, jnp.float32) for k, v in dr.items()})
    ts = tenv.reset_where(
        tenv.init_state(N), torch.ones(N, dtype=torch.bool),
        init_sampler(tenv.motion.num_motions, tenv.task.sampler_num_segments),
        draws=(np.asarray(ids), np.asarray(times), dr),
    )
    return js, ts


def test_latency_blend_and_per_env_step_match_jax(envs):
    jenv, tenv = envs["jenv"], envs["tenv"]
    dr = _np_dr(3)
    js, ts = _reset_pair(envs, jax.random.PRNGKey(4), dr)
    for k in DR_KEYS:
        np.testing.assert_allclose(ts.dr[k].numpy(), dr[k].astype(np.float32), err_msg=k)
    # a command far from the held target, so the blend moves it
    rng = np.random.default_rng(5)
    action = (np.asarray(js.sim.pd_target) + rng.uniform(-0.3, 0.3, (N, jenv.num_dofs))
              ).astype(np.float32)
    r_dr = _np_dr(6)
    r_ids = np.zeros(N, np.int32)
    r_times = np.zeros(N, np.float32)

    step = jax.jit(jenv.rollout_step_cached)
    j3, _, _, jout = step(js, jnp.asarray(action), jenv.motion_aux(js), jnp.asarray(r_ids),
                          jnp.asarray(r_times), {k: jnp.asarray(v, jnp.float32)
                                                 for k, v in r_dr.items()})
    t_dr = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in r_dr.items()}
    t3, _, _, tout = tenv.rollout_step_cached(ts, torch.as_tensor(action), tenv.motion_aux(ts),
                                             torch.as_tensor(r_ids), torch.as_tensor(r_times),
                                             t_dr)
    tols = fx.step_tolerances()
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(t3.sim, f).numpy(), np.asarray(getattr(j3.sim, f)),
                                   err_msg=f, **tols[f])
    np.testing.assert_allclose(tout["reward"].numpy(), np.asarray(jout["reward"]),
                               rtol=1e-4, atol=1e-4)

    # the latency blend moved the applied target: without it the step differs
    no_lat = dataclasses.replace(ts, dr=dict(ts.dr, latency=torch.zeros(N)))
    t3b = tenv.rollout_step_cached(no_lat, torch.as_tensor(action), tenv.motion_aux(ts),
                                   torch.as_tensor(r_ids), torch.as_tensor(r_times), t_dr)[0]
    assert not torch.allclose(t3b.sim.pd_target, t3.sim.pd_target)


def test_full_latency_holds_the_previous_target(envs):
    """a = 1 applies the previous target: the command has no effect."""
    tenv = envs["tenv"]
    dr = _np_dr(7)
    dr["latency"][:] = 1.0
    _, ts = _reset_pair(envs, jax.random.PRNGKey(8), dr)
    aux = tenv.motion_aux(ts)
    resets = (torch.zeros(N, dtype=torch.int64), torch.zeros(N),
              {k: torch.as_tensor(v, dtype=torch.float32) for k, v in dr.items()})
    a = tenv.rollout_step_cached(ts, ts.sim.pd_target + 0.5, aux, *resets)[0]
    b = tenv.rollout_step_cached(ts, ts.sim.pd_target - 0.5, aux, *resets)[0]
    torch.testing.assert_close(a.sim.dof_pos, b.sim.dof_pos, rtol=0, atol=0)


# ------------------------------------------------------------- resets


def test_reset_where_draws_dr_for_masked_envs(envs):
    tenv = envs["tenv"]
    sampler = init_sampler(tenv.motion.num_motions, tenv.task.sampler_num_segments)
    g = torch.Generator().manual_seed(0)
    es = tenv.init_state(N)
    assert torch.equal(es.dr["kp_scale"], torch.ones(N))
    es = tenv.reset_where(es, torch.ones(N, dtype=torch.bool), sampler, generator=g)
    b = _dr_block()
    for k, rng in (("kp_scale", b["kp_scale_range"]), ("friction_mu", b["friction_range"]),
                   ("latency", b["action_latency_range"]), ("mass_scale", MASS_RANGE)):
        x = es.dr[k]
        assert float(x.std()) > 0.0 and bool(((x >= rng[0]) & (x <= rng[1])).all()), k
    mask = torch.zeros(N, dtype=torch.bool)
    mask[0] = True
    es2 = tenv.reset_where(es, mask, sampler, generator=g)
    for k in DR_KEYS:
        assert torch.equal(es2.dr[k][1:], es.dr[k][1:]), k
        assert not torch.equal(es2.dr[k][:1], es.dr[k][:1]), k


# ------------------------------------------------------------- rollout


def test_dr_rollout_lean_matches_jax(envs):
    jenv, tenv = envs["jenv"], envs["tenv"]
    jagent = jax_build_agent(envs["jcfg"], jenv)
    tagent = build_agent(envs["tcfg"], tenv)
    jts = jagent.init_train_state()
    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(N), jnp.ones(N, bool), jts.sampler)
    ep_time = np.zeros(N, np.float32)
    ep_time[:2] = envs["jcfg"]["task"]["max_episode_length"] - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    jobs = jenv.compute_obs(jes)
    k1, k2, k_dr = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, N)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)
    r_dr = {k: np.asarray(v) for k, v in jax_sample_dr(k_dr, jenv.dr, N).items()}

    key = jax.random.PRNGKey(3)
    jes2, jobs2, jtraj, jstats = jax.jit(
        lambda ts, es, obs, k: jagent.rollout_lean(ts, es, obs, k, T))(jts, jes, jobs, key)
    k_noise, k_bern, k_ids, k_times, k_dr = jax.random.split(key, 5)
    noise = jax.random.normal(k_noise, (T, N, jenv.num_dofs))
    bern = jax.random.bernoulli(k_bern, jagent._exp_prob(jts.sample_count), (T, N, 1))
    ids_f = jenv.motion.sample_motions(k_ids, T * N)
    times_f = jenv._sample_times(k_times, ids_f, jts.sampler).reshape(T, N)
    dr_f = {k: np.asarray(v).reshape(T, N) for k, v in jax_sample_dr(k_dr, jenv.dr, T * N).items()}

    tts = from_jax(tagent, jts)
    tes = tenv.reset_where(tenv.init_state(N), torch.ones(N, dtype=torch.bool), tts.sampler,
                           draws=(np.asarray(r_ids), np.asarray(r_times), r_dr))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    tobs = tenv.compute_obs(tes)
    draws = (np.asarray(noise), np.asarray(bern, np.float32), np.asarray(ids_f).reshape(T, N),
             np.asarray(times_f), dr_f)
    tes2, tobs2, ttraj, tstats = tagent.rollout_lean(tts, tes, tobs, T, draws=draws)

    tol = 1e-4
    assert set(ttraj) == set(jtraj)
    for k in sorted(jtraj):
        a, b = np.asarray(jtraj[k], np.float32), ttraj[k].float().numpy()
        if k in ("done", "motion_ids", "rand_mask"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=k)
    assert (np.asarray(jtraj["done"])[0, :2] != 0).all()      # the reset path ran
    for a, b, name in zip(jstats, tstats, ("count", "sum", "sum_sq")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=tol, atol=tol)
    for k in DR_KEYS:
        np.testing.assert_allclose(tes2.dr[k].numpy(), np.asarray(jes2.dr[k]), rtol=1e-6,
                                   err_msg=k)
    # the two envs that reset on the first step took dr_f's draws
    np.testing.assert_allclose(tes2.dr["mass_scale"][:2].numpy(), dr_f["mass_scale"][0, :2],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="dr_f"):
        tagent.rollout_lean(tts, tes, tobs, T, draws=draws[:4])
