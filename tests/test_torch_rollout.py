"""The slice as a whole: ``rollout_lean`` of the port against the JAX package.

Both packages are built from config ``train`` on the G1-shaped fixture and
a synthetic clip (N=8 envs, T=4 control steps, 64-unit nets).  The JAX
train state is carried across with ``convert.from_jax`` (with a non-trivial
obs normalizer and sampler state), and the port is fed the JAX package's
own random draws: the reset draws of ``reset_where`` and the presampled
noise / Bernoulli mask / reset ids / reset times that ``rollout_lean``
draws from its key.  Every traj tensor, the obs statistics, the final obs
and the final env state are compared.

Tolerances: in f32 the two packages run the same arithmetic in other op
orders, so per-step values agree to a few f32 ulps; over 4 chained steps
with stiff contacts that grows to ~1e-5, hence rtol = atol = 1e-4.  Under
mixed precision the actor trunk runs in bf16 (8 mantissa bits), and XLA
and torch round its matmuls at other places: the action mean differs by a
few bf16 ulps of the hidden activations, which moves the actions, and the
physics carries that forward, hence rtol = atol = 2e-2 there (recorded
normalized obs are bf16 themselves).

The env's graph scope on the CPU: ``rollout_lean`` opens
``ImitationEnv.graphed_steps``, and on CPU tensors the step runs eagerly in
it, bit for bit as with a null scope.  The warm-up step and
``_StepGraph``'s buffers (inputs copied in, outputs copied out) are held to
the eager body with a stand-in for the CUDA graph that reruns the captured
body.
"""

import contextlib
import dataclasses
import gc

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.envs import imitation
from add_gym_torch.envs.imitation import ImitationEnv
from add_gym_torch.learning.convert import from_jax
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 8, 4
SMALL_NET = "fc_2layers_64units"


def _cfg(load, mjcf, clip, mixed):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["task"]["motion_file"] = clip
    cfg["engine"]["num_envs"] = N
    cfg["agent"]["steps_per_iter"] = T
    cfg["agent"]["mixed_precision"] = mixed
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = SMALL_NET
    return cfg


def _run_both(tmp_path, mixed):
    mjcf = fx.write_g1_fixture(str(tmp_path))
    clip = fx.write_motion_csv(str(tmp_path / "clip.motion"), seed=5, num_frames=120)

    # ---- JAX reference
    jcfg = _cfg(jax_load_config, mjcf, clip, mixed)
    jenv = jax_build_env(jcfg)
    jagent = jax_build_agent(jcfg, jenv)
    jts = jagent.init_train_state()
    rng = np.random.default_rng(11)
    d = jenv.obs_dim()
    mean = rng.normal(0.0, 0.3, d).astype(np.float32)
    std = rng.uniform(0.5, 2.0, d).astype(np.float32)
    jts = dataclasses.replace(
        jts,
        obs_norm=dataclasses.replace(
            jts.obs_norm, count=jnp.float32(100.0), mean=jnp.asarray(mean),
            mean_sq=jnp.asarray(std * std + mean * mean),
        ),
        sampler=dataclasses.replace(
            jts.sampler,
            errors=jnp.asarray(rng.uniform(0.5, 2.0, jts.sampler.errors.shape), jnp.float32),
        ),
    )
    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(N), jnp.ones(N, bool), jts.sampler)
    # two episodes end on the first step (TIME), so the rollout's masked
    # reset path runs
    ep_time = np.zeros(N, np.float32)
    ep_time[:2] = jcfg["task"]["max_episode_length"] - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    jobs = jenv.compute_obs(jes)
    # the draws reset_where took from key0
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, N)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)

    key = jax.random.PRNGKey(3)
    jes2, jobs2, jtraj, jstats = jax.jit(
        lambda ts, es, obs, k: jagent.rollout_lean(ts, es, obs, k, T)
    )(jts, jes, jobs, key)
    # the draws rollout_lean takes from its key
    k_noise, k_bern, k_ids, k_times, _ = jax.random.split(key, 5)
    noise = jax.random.normal(k_noise, (T, N, jenv.num_dofs))
    bern = jax.random.bernoulli(
        k_bern, jagent._exp_prob(jts.sample_count), (T, N, 1)
    ).astype(jnp.float32)
    ids_f = jenv.motion.sample_motions(k_ids, T * N)
    times_f = jenv._sample_times(k_times, ids_f, jts.sampler).reshape(T, N)
    ids_f = ids_f.reshape(T, N)

    # ---- the port on the same inputs
    tcfg = _cfg(load_config, mjcf, clip, mixed)
    tenv = build_env(tcfg, device="cpu")
    tagent = build_agent(tcfg, tenv)
    tts = from_jax(tagent, jts)
    tes = tenv.reset_where(
        tenv.init_state(N), torch.ones(N, dtype=torch.bool), tts.sampler,
        draws=(np.asarray(r_ids), np.asarray(r_times)),
    )
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    tobs = tenv.compute_obs(tes)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-5)
    tes2, tobs2, ttraj, tstats = tagent.rollout_lean(
        tts, tes, tobs, T,
        draws=tuple(np.asarray(x) for x in (noise, bern, ids_f, times_f)),
    )
    return (jes2, jobs2, jtraj, jstats), (tes2, tobs2, ttraj, tstats)


@pytest.mark.parametrize("mixed,tol", [(False, 1e-4), (True, 2e-2)], ids=["f32", "bf16"])
def test_rollout_lean_matches_jax(tmp_path, mixed, tol):
    (jes, jobs, jtraj, jstats), (tes, tobs, ttraj, tstats) = _run_both(tmp_path, mixed)

    assert set(ttraj) == set(jtraj)
    for k in sorted(jtraj):
        a = np.asarray(jnp.asarray(jtraj[k], jnp.float32))
        b = ttraj[k].float().numpy()
        assert a.shape == b.shape, k
        if k in ("done", "motion_ids", "rand_mask"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=k)
    # the rollout resets, so the reset path is covered
    assert (np.asarray(jtraj["done"])[0, :2] != 0).all()
    for a, b, name in zip(jstats, tstats, ("count", "sum", "sum_sq")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=tol, atol=tol)
    for f in ("root_pos", "root_quat", "root_vel", "root_ang_vel", "dof_pos", "dof_vel", "pd_target"):
        np.testing.assert_allclose(
            getattr(tes.sim, f).numpy(), np.asarray(getattr(jes.sim, f)),
            rtol=tol, atol=tol, err_msg=f,
        )
    np.testing.assert_array_equal(tes.motion_ids.numpy(), np.asarray(jes.motion_ids))


# ---------------------------------------------------------------- the graph scope


def _port_case(tmp_path, n=N, steps=T):
    mjcf = fx.write_g1_fixture(str(tmp_path))
    clip = fx.write_motion_csv(str(tmp_path / "clip.motion"), seed=5, num_frames=120)
    cfg = _cfg(load_config, mjcf, clip, False)
    cfg["engine"]["num_envs"] = n
    cfg["agent"]["steps_per_iter"] = steps
    env = build_env(cfg, device="cpu")
    agent = build_agent(cfg, env)
    ts = agent.init_train_state()
    g = torch.Generator().manual_seed(2)
    es = env.reset_where(env.init_state(n), torch.ones(n, dtype=torch.bool), ts.sampler,
                         generator=g)
    # every other episode ends on the first step: the reset path runs
    last = cfg["task"]["max_episode_length"] - 0.005
    es = dataclasses.replace(es, time=torch.where(torch.arange(n) % 2 == 0, last, 0.0))
    return env, agent, ts, es, env.compute_obs(es), agent.sample_rollout_draws(ts, n, steps, g)


def _step_counts():
    f = imitation._step_counts
    return f.captures, f.replays, f.eager


def test_graph_scope_on_cpu_runs_eagerly(tmp_path, monkeypatch):
    """``rollout_lean`` opens the env's graph scope; on CPU tensors
    ``rollout_step_cached`` runs its body eagerly inside it (the counters
    read T eager steps, no capture, no replay), and the rollout's outputs
    are those of the same rollout with a null scope in its place, bit for
    bit."""
    env, agent, ts, es, obs, draws = _port_case(tmp_path)
    scoped = []
    body = ImitationEnv._rollout_step_body

    def spy(self, *args):
        scoped.append(self._graph_scope)
        return body(self, *args)

    monkeypatch.setattr(ImitationEnv, "_rollout_step_body", spy)
    c0 = _step_counts()
    got = agent.rollout_lean(ts, es, obs, T, draws=draws)
    assert tuple(b - a for a, b in zip(c0, _step_counts())) == (0, 0, T)
    assert scoped == [True] * T and not env._graph_scope
    monkeypatch.setattr(ImitationEnv, "graphed_steps", lambda self: contextlib.nullcontext())
    want = agent.rollout_lean(ts, es, obs, T, draws=draws)
    assert scoped == [True] * T + [False] * T
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    assert (want[2]["done"][0] != 0).any()
    assert torch.equal(got[1], want[1])
    for a, b in zip(got[3], want[3]):
        assert torch.equal(a, b)
    for a, b in zip(imitation._leaves(got[0]), imitation._leaves(want[0])):
        assert torch.equal(a, b)


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the body run under capture
    computes its outputs and then poisons them (a capture computes
    nothing); a replay runs the body again on the captured inputs and
    writes into the captured outputs."""

    capturing = []
    collecting = []                 # the garbage collector's state at each capture

    def capture_begin(self, pool=None):
        _StandInGraph.capturing.append(self)
        _StandInGraph.collecting.append(gc.isenabled())

    def capture_end(self):
        _StandInGraph.capturing.pop()

    def pool(self):
        return (0, 1)

    def replay(self):
        for a, b in zip(imitation._leaves(self.outs), imitation._leaves(self.body(*self.args))):
            a.copy_(b)


class _StandInStream:
    def wait_stream(self, other):
        pass


def test_step_graph_buffers_with_a_stand_in_graph(tmp_path, monkeypatch):
    """``_StepGraph``'s buffers on the CPU with a stand-in for the CUDA
    graph (``_StandInGraph``), after the env's warm-up step: the warm-up
    step and then 6 chained steps with resets each return what the eager
    body returns on the same inputs, bit for bit, with the eager outputs'
    shapes and strides; a returned tensor is not written by a later
    replay; an input state it did not return is loaded as well; the
    launch counter counts the warm-up step's launch and each replay's, not
    the capture's; the garbage collector is paused during the capture and
    running again after it."""
    steps = 6
    env, agent, ts, es, obs, draws = _port_case(tmp_path, steps=steps)
    _, _, ids_f, times_f = draws
    dr = env.sample_dr(N)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    real = env._rollout_step_body
    monkeypatch.setattr(imitation.cs.cuda_step, "launches", 0)

    def body(*args):
        imitation.cs.cuda_step.launches += 1          # the kernel's launch
        out = real(*args)
        if _StandInGraph.capturing:
            graph = _StandInGraph.capturing[-1]
            graph.body, graph.args, graph.outs = real, args, out
            inputs = {t.untyped_storage().data_ptr() for t in imitation._leaves(args)}
            for t in imitation._leaves(out):
                if t.untyped_storage().data_ptr() not in inputs:
                    t.fill_(-7)
        return out

    monkeypatch.setattr(env, "_rollout_step_body", body)
    aux = env.motion_aux(es)
    act = lambda s: s.sim.pd_target + 0.05
    args = (es, act(es), aux, ids_f[0], times_f[0], dr)
    c0 = _step_counts()
    for a, b in zip(imitation._leaves(env._warm_step(args, "cpu")), imitation._leaves(real(*args))):
        assert a.stride() == b.stride() and torch.equal(a, b)
    assert imitation.cs.cuda_step.launches == 1
    graph = imitation._StepGraph(env, args, "cpu")
    assert imitation.cs.cuda_step.launches == 1
    assert tuple(b - a for a, b in zip(c0, _step_counts())) == (1, 0, 1)
    assert env._graph_warm == {"cpu"}
    assert _StandInGraph.collecting == [False] and gc.isenabled()
    state, kept = es, None
    for t in range(steps):
        args = (state, act(state), aux, ids_f[t], times_f[t], dr)
        want = real(*args)
        got = graph(args)
        for a, b in zip(imitation._leaves(got), imitation._leaves(want)):
            assert a.stride() == b.stride() and torch.equal(a, b), t
        if t == 1:
            kept = [x.clone() for x in imitation._leaves(got)], imitation._leaves(got)
        state, aux = got[0], got[2]
    assert tuple(b - a for a, b in zip(c0, _step_counts())) == (1, steps, 1)
    assert imitation.cs.cuda_step.launches == 1 + steps
    assert all(torch.equal(a, b) for a, b in zip(*kept))
    assert not torch.equal(kept[1][0], state.sim.root_pos)
    # a state the graph did not return
    fresh = imitation._builder(state)(iter([x.clone() for x in imitation._leaves(state)]))
    args = (fresh, act(fresh), aux.clone(), ids_f[0], times_f[0], dr)
    for a, b in zip(imitation._leaves(graph(args)), imitation._leaves(real(*args))):
        assert torch.equal(a, b)
