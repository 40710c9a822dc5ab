"""Port parity: the update path and one whole training iteration.

Both packages are built from config ``train`` on the G1-shaped fixture and
a synthetic clip (N=8 envs, T=4 control steps, ``fc_2layers_64units``
nets, ``batch_size`` 2: two minibatches of 16 samples, five epochs).  The
JAX train state (with a non-trivial obs normalizer and sampler) is carried
across with ``convert.from_jax``; the port gets the JAX package's random
draws (rollout noise, resets and minibatch permutations).  Each part is fed
the same inputs in both packages:

* ``td_lambda_return`` on numpy-seeded rewards, values and dones: 1e-6
  (the same recursion, other op order);
* ``build_train_data`` on one trajectory with every done kind: rewards,
  ``tar_val``, ``adv``, the disc input and the sampler errors, 1e-5 in f32
  (a 64-unit critic and disc in other summation orders), 2e-2 in bf16
  (the critic trunk rounds at other places);
* ``_loss`` on one fixed minibatch: each loss term at rtol 1e-4, atol
  1e-6, and every parameter gradient (the gradient penalty's double
  backward included, see below) in f32;
* the port's one clipped-Adam step against both JAX optimizers,
  ``fused_adam`` and ``adam``, on the same gradients: 1e-6;
* ``update_model`` with the JAX permutations, then a second one from the
  JAX state after the first (Adam moments carried by ``from_jax``), and a
  whole ``train_iter`` chained from the JAX state, in f32 and bf16.

Parameter deltas after the update are held with an absolute tolerance in
units of the learning rate ``lr`` = 1e-4.  Adam's first steps move each
element by about ``lr * sign(g)``: an element whose gradient is near zero
(|g| close to Adam's eps, or a sum that cancels) can take the other sign
from f32 noise in the gradient, and then differs by up to 2 lr per step
over the 10 steps.  The tolerance is 2 lr, and at most 1% of the elements
may differ by more than 0.05 lr in f32 (measured: 99% within 5e-5 lr) or
by more than 0.5 lr in bf16, where the trunk gradients themselves round at
other places (measured: 99% within 0.28 lr).  Gradients are held at rtol
1e-4 and an absolute 1e-5 of each tensor's largest element (the actor
head's reach ~15 through the action-bound loss; measured 7e-6).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.learning.add_agent import td_lambda_return as jax_td_lambda
from add_gym_tpu.learning.optim import fused_clip_adam
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.learning import add_agent as port_agent
from add_gym_torch.learning import optim
from add_gym_torch.learning.convert import _flax_like_params, from_jax
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 8, 4
SMALL_NET = "fc_2layers_64units"
LR = 1e-4


def _cfg(load, mjcf, clip, mixed):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["task"]["motion_file"] = clip
    cfg["engine"]["num_envs"] = N
    cfg["agent"]["steps_per_iter"] = T
    cfg["agent"]["batch_size"] = 2
    cfg["agent"]["mixed_precision"] = mixed
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = SMALL_NET
    return cfg


def to_jnp(x):
    if isinstance(x, dict):
        return {k: to_jnp(v) for k, v in x.items()}
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if x.dtype == torch.int64:
        return jnp.asarray(x.numpy().astype(np.int32))
    return jnp.asarray(x.numpy())


def to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


class Pair:
    """The JAX agent and the port's on the same fixture and config."""

    def __init__(self, mjcf, clip, mixed):
        self.jcfg = _cfg(jax_load_config, mjcf, clip, mixed)
        self.jenv = jax_build_env(self.jcfg)
        self.jagent = jax_build_agent(self.jcfg, self.jenv)
        jts = self.jagent.init_train_state(jax.random.PRNGKey(7))
        rng = np.random.default_rng(11)
        d = self.jenv.obs_dim()
        mean = rng.normal(0.0, 0.3, d).astype(np.float32)
        std = rng.uniform(0.5, 2.0, d).astype(np.float32)
        self.jts = dataclasses.replace(
            jts,
            obs_norm=dataclasses.replace(
                jts.obs_norm, count=jnp.float32(100.0), mean=jnp.asarray(mean),
                mean_sq=jnp.asarray(std * std + mean * mean),
            ),
            disc_norm=dataclasses.replace(
                jts.disc_norm, count=jnp.float32(100.0),
                mean_abs=jnp.asarray(rng.uniform(0.05, 0.5, jts.disc_norm.mean_abs.shape),
                                     jnp.float32),
            ),
            sampler=dataclasses.replace(
                jts.sampler,
                errors=jnp.asarray(rng.uniform(0.5, 2.0, jts.sampler.errors.shape), jnp.float32),
            ),
        )
        tcfg = _cfg(load_config, mjcf, clip, mixed)
        self.tenv = build_env(tcfg, device="cpu")
        self.tagent = build_agent(tcfg, self.tenv)

    def port_state(self):
        return from_jax(self.tagent, self.jts)

    def port_traj(self):
        """A port rollout trajectory (the port's own draws), with every done
        kind written into it."""
        ts = self.port_state()
        g = torch.Generator().manual_seed(3)
        es = self.tenv.reset_where(self.tenv.init_state(N), torch.ones(N, dtype=torch.bool),
                                   ts.sampler, generator=g)
        traj = self.tagent.rollout_lean(ts, es, self.tenv.compute_obs(es), T, generator=g)[2]
        done = np.zeros((T, N), np.int32)
        done[0, :4] = [1, 2, 3, 0]        # FAIL, SUCC, TIME, NULL
        done[2, 4:7] = [2, 3, 1]
        traj["done"] = torch.as_tensor(done)
        traj["rand_mask"][1, ::3] = 0.0   # some deterministic actions
        # motion times are multiples of the control dt, and so is every
        # sixth segment boundary of this clip: a time on a boundary falls in
        # either segment by one f32 ulp of time / size, so move them off
        traj["motion_times"] = traj["motion_times"] + 0.003
        return traj


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    return fx.write_g1_fixture(str(d)), fx.write_motion_csv(str(d / "clip.motion"), seed=5,
                                                            num_frames=120)


@pytest.fixture(scope="module")
def pairs(files):
    cache = {}

    def get(mixed):
        if mixed not in cache:
            cache[mixed] = Pair(*files, mixed)
        return cache[mixed]

    return get


def _jax_perms(key, epochs, nblk):
    return [np.asarray(jax.random.permutation(k, nblk)) for k in jax.random.split(key, epochs)]


def _assert_params_close(net, jax_params, what, bulk=0.05):
    """Parameter values within the lr-unit tolerance of the module docstring:
    all within 2 lr, and 99% within ``bulk`` lr."""
    want = _flax_like_params(net, jax_params)
    diffs = np.concatenate([(p.detach() - w).abs().flatten().numpy()
                            for p, w in zip(net.parameters(), want)])
    assert diffs.max() <= 2 * LR, f"{what}: max |delta| {diffs.max() / LR:.3f} lr"
    assert np.mean(diffs > bulk * LR) <= 0.01, (
        f"{what}: {np.mean(diffs > bulk * LR):.4f} of the elements differ by > {bulk} lr")


# ------------------------------------------------------------------ parts


def test_td_lambda_return():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(16, 5)).astype(np.float32)
    v = rng.normal(size=(16, 5)).astype(np.float32)
    done = rng.choice(4, size=(16, 5), p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
    want = jax_td_lambda(jnp.asarray(r), jnp.asarray(v), jnp.asarray(done), 0.99, 0.95)
    got = port_agent.td_lambda_return(torch.as_tensor(r), torch.as_tensor(v),
                                      torch.as_tensor(done), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mixed,tol", [(False, 1e-5), (True, 2e-2)], ids=["f32", "bf16"])
def test_build_train_data(pairs, mixed, tol):
    pair = pairs(mixed)
    traj = pair.port_traj()
    jts, jdata, jinfo = jax.jit(pair.jagent.build_train_data)(pair.jts, to_jnp(traj))
    tts, tdata, tinfo = pair.tagent.build_train_data(pair.port_state(), traj)
    for k in ("reward", "tar_val", "adv", "disc_in"):
        np.testing.assert_allclose(to_np(tdata[k]), to_np(jdata[k]), rtol=tol, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(tts.sampler.errors.numpy(), np.asarray(jts.sampler.errors),
                               rtol=1e-6, atol=1e-6)
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(to_np(tinfo[k]), to_np(jinfo[k]), rtol=tol, atol=tol,
                                   err_msg=k)
    # the terminal dones zero the bootstrap: the return differs from a
    # run that ignores them
    assert np.abs(np.asarray(jdata["adv"])).max() > 0.1


def test_loss_terms_and_gradients(pairs):
    pair = pairs(False)
    traj = pair.port_traj()
    _, jdata, _ = jax.jit(pair.jagent.build_train_data)(pair.jts, to_jnp(traj))
    rows = np.random.default_rng(1).permutation(T * N)[:16]
    batch = {k: jnp.asarray(jdata[k]).reshape((T * N,) + jdata[k].shape[2:])[rows]
             for k in port_agent.UPDATE_FIELDS}
    (jloss, jinfo), jgrads = jax.jit(jax.value_and_grad(pair.jagent._loss, has_aux=True))(
        pair.jts.params, batch)

    ts = pair.port_state()
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    tloss, tinfo = pair.tagent._loss(ts.params, tbatch)
    tgrads = torch.autograd.grad(tloss, list(ts.params.parameters()))

    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(jinfo["disc_grad_penalty"]) > 0.0
    want = _flax_like_params(ts.params, jgrads)
    for (name, _), g, w in zip(ts.params.named_parameters(), tgrads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()), err_msg=name)
    # the disc trunk's gradient carries the penalty's second-order term
    assert float(tgrads[-3].abs().max()) > 0.0


@pytest.mark.parametrize("kind", ["fused_adam", "adam"])
def test_optimizer_step(pairs, kind):
    import optax

    pair = pairs(False)
    params = pair.jts.params
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0.0, 0.5, p.shape), jnp.float32), params)
    if kind == "fused_adam":
        opt = fused_clip_adam(LR, clip=1.0)
    else:
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=0.0))
    jstate = opt.init(params)
    # two steps: the second one runs on non-zero moments
    tstate = optim.init_adam(pair.port_state().params.parameters())
    net = pair.port_state().params
    for _ in range(2):
        upd, jstate = opt.update(grads, jstate, params)
        params = optax.apply_updates(params, upd)
        tstate = optim.clip_adam_step(list(net.parameters()), _flax_like_params(net, grads),
                                      tstate, LR, 1.0)
    for p, w in zip(net.parameters(), _flax_like_params(net, params)):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=0, atol=1e-6)
    from add_gym_torch.learning.convert import load_adam_state

    moments = load_adam_state(net, jstate)
    assert int(moments.count) == int(tstate.count) == 2
    for a, b in zip(tstate.mu + tstate.nu, moments.mu + moments.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)


def test_update_model_with_injected_permutations(pairs):
    pair = pairs(False)
    traj = pair.port_traj()
    jts, jdata, _ = jax.jit(pair.jagent.build_train_data)(pair.jts, to_jnp(traj))
    key = jax.random.PRNGKey(5)
    jts2, jinfo = jax.jit(pair.jagent.update_model)(jts, jdata, key)

    tts = pair.port_state()
    tdata = {k: torch.as_tensor(np.array(jdata[k])) for k in port_agent.UPDATE_FIELDS + ("reward",)}
    perms = _jax_perms(key, pair.tagent.cfg.update_epochs, 4)
    tts2, tinfo = pair.tagent.update_model(tts, tdata, perms=perms)
    _assert_params_close(tts2.params, jts2.params, "params")
    assert int(tts2.opt_state.count) == int(jts2.opt_state.count) == 10
    for k in ("loss", "critic_loss", "actor_loss", "disc_loss", "disc_grad_penalty"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)

    # a second update from the JAX state after the first: from_jax carries
    # the Adam moments and step count (bias correction at t = 11..20)
    key2 = jax.random.PRNGKey(6)
    jts3, _ = jax.jit(pair.jagent.update_model)(jts2, jdata, key2)
    tts3 = from_jax(pair.tagent, jts2)
    assert int(tts3.opt_state.count) == 10
    tts3, _ = pair.tagent.update_model(tts3, tdata, perms=_jax_perms(key2, 5, 4))
    _assert_params_close(tts3.params, jts3.params, "params after the second update")
    assert int(tts3.opt_state.count) == int(jts3.opt_state.count) == 20


def test_normalizer_updates_match_jax():
    """The three normalizer merges on the same numpy-seeded batches: 1e-6."""
    from add_gym_tpu.learning import normalizer as jnorm
    from add_gym_torch.learning import normalizer as tnorm

    rng = np.random.default_rng(4)
    batch = rng.normal(0.5, 2.0, (4, 8, 6)).astype(np.float32)
    j, t = jnorm.init_normalizer((6,)), tnorm.init_normalizer((6,))
    for _ in range(2):
        j, t = jnorm.update_normalizer(j, jnp.asarray(batch)), tnorm.update_normalizer(
            t, torch.as_tensor(batch))
        batch = 0.5 * batch + 1.0
    stats = (32.0, batch.reshape(-1, 6).sum(0), (batch.reshape(-1, 6) ** 2).sum(0))
    j = jnorm.update_normalizer_from_stats(j, *(jnp.asarray(x) for x in stats))
    t = tnorm.update_normalizer_from_stats(t, *(torch.as_tensor(x) for x in stats))
    for f in ("count", "mean", "mean_sq"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    jd, td = jnorm.init_diff_normalizer((6,)), tnorm.init_diff_normalizer((6,))
    for _ in range(2):
        jd = jnorm.update_diff_normalizer(jd, jnp.asarray(batch))
        td = tnorm.update_diff_normalizer(td, torch.as_tensor(batch))
        batch = batch - 1.5
    for f in ("count", "mean_abs"):
        np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_pick_shuffle_block():
    assert port_agent.pick_shuffle_block(32, 2, 16, 8) == 8
    assert port_agent.pick_shuffle_block(131072, 8, 16384, 4096) == 32
    assert port_agent.pick_shuffle_block(131072, 8, 16384, 4096, "timestep") == 4096
    assert port_agent.pick_shuffle_block(30, 2, 15, 5) == 1
    with pytest.raises(ValueError, match="minibatch_blocks"):
        port_agent.pick_shuffle_block(32, 2, 16, 8, "timesteps")


# ------------------------------------------------------------ train_iter


@pytest.mark.parametrize("mixed,tol,bulk", [(False, 1e-4, 0.05), (True, 2e-2, 0.5)],
                         ids=["f32", "bf16"])
def test_train_iter_matches_jax(pairs, mixed, tol, bulk):
    pair = pairs(mixed)
    jenv, jagent, tenv, tagent = pair.jenv, pair.jagent, pair.tenv, pair.tagent
    jts = pair.jts
    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(N), jnp.ones(N, bool), jts.sampler)
    ep_time = np.zeros(N, np.float32)
    ep_time[:2] = pair.jcfg["task"]["max_episode_length"] - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    jobs = jenv.compute_obs(jes)
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, N)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)

    # the port's state before the JAX call (train_iter donates its inputs)
    tts = pair.port_state()
    tes = tenv.reset_where(tenv.init_state(N), torch.ones(N, dtype=torch.bool), tts.sampler,
                           draws=(np.asarray(r_ids), np.asarray(r_times)))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    tobs = tenv.compute_obs(tes)

    key = jax.random.PRNGKey(9)
    k_roll, _, k_upd = jax.random.split(key, 3)
    k_noise, k_bern, k_ids, k_times, _ = jax.random.split(k_roll, 5)
    noise = jax.random.normal(k_noise, (T, N, jenv.num_dofs))
    bern = jax.random.bernoulli(k_bern, jagent._exp_prob(jts.sample_count), (T, N, 1))
    ids_f = jenv.motion.sample_motions(k_ids, T * N)
    times_f = jenv._sample_times(k_times, ids_f, jts.sampler).reshape(T, N)
    draws = tuple(np.asarray(x, np.float32 if x.dtype == bool else x.dtype)
                  for x in (noise, bern, ids_f.reshape(T, N), times_f))
    perms = _jax_perms(k_upd, tagent.cfg.update_epochs, 4)

    jts2, jes2, jobs2, jinfo = jagent.train_iter(jts, jes, jobs, key)
    tts2, tes2, tobs2, tinfo = tagent.train_iter(tts, tes, tobs, draws=draws, perms=perms)

    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(to_np(tinfo[k]), to_np(jinfo[k]), rtol=tol, atol=tol,
                                   err_msg=k)
    assert float(jinfo["done_frac"]) > 0.0                 # the reset path ran
    _assert_params_close(tts2.params, jts2.params, "params", bulk)
    for f in ("count", "mean", "mean_sq"):
        np.testing.assert_allclose(to_np(getattr(tts2.obs_norm, f)),
                                   to_np(getattr(jts2.obs_norm, f)), rtol=tol, atol=tol,
                                   err_msg=f"obs_norm.{f}")
    np.testing.assert_allclose(to_np(tts2.disc_norm.mean_abs), to_np(jts2.disc_norm.mean_abs),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(to_np(tts2.sampler.errors), to_np(jts2.sampler.errors),
                               rtol=tol, atol=tol)
    assert int(tts2.sample_count) == int(jts2.sample_count) == T * N
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tes2.motion_ids.numpy(), np.asarray(jes2.motion_ids))
