"""Port parity of every agent mode: AMP, plain PPO, SGD and the learned
action std, the categorical head and the conv trunk.

Both packages are built from config ``train`` with the mode's overrides
(``agent=amp_g1``, ``agent=ppo_g1``, ``agent.optimizer=sgd``,
``agent.actor_std_type=constant|variable``), f32, ``fc_2layers_64units``
nets, N=8 envs, T=4 control steps, ``batch_size`` 2 (two minibatches of 16
samples, five epochs).  The JAX train state (with non-trivial normalizers
of the mode's kind and sampler errors) is carried across with
``convert.from_jax``; the port gets the JAX package's random draws: the
rollout noise and resets, the minibatch permutations and, under AMP, the
motion ids and start times of the fresh demo windows, drawn by JAX's own
``motion.sample_motions`` / ``_sample_times`` from the split of the data
key.  Tolerances:

* ``build_train_data`` (``amp``, ``none``; G1-shaped fixture, a port
  trajectory with every done kind): reward, ``tar_val``, ``adv``,
  ``disc_in``, ``disc_pos``, the fresh demo obs, the sampler errors and
  the infos at 1e-5;
* ``_loss`` (``amp``, ``none``, ``constant``, ``variable``) on one fixed
  minibatch: each term at rtol 1e-4, atol 1e-6, every gradient at rtol
  1e-4 and an absolute 1e-5 of the tensor's largest element, as
  ``tests/test_torch_train.py``;
* one ``clip_sgd_step`` against the optax chain: parameters at atol 1e-6,
  the momentum trace at rtol 1e-6;
* one whole ``train_iter`` per mode on the mini biped (its JAX compile is
  ~10 s against ~70 s on the G1-shaped fixture): parameters within the
  lr-unit bound of ``tests/test_torch_train.py`` (all within 2 lr, 99%
  within 0.05 lr; see its docstring), the normalizers, the sampler and
  the infos at 1e-4;
* the categorical head on fixed logits: ``mode`` equal to JAX's exactly,
  ``log_prob``, ``entropy`` and ``param_reg`` at 1e-6 (they reduce over
  the classes in another order than XLA: measured 1 ulp, 1.9e-6 of 25.4),
  ``sample`` in range and its frequencies within 0.03 of the
  probabilities over 4000 draws;
* the conv trunk's forward on a seeded ``[2, 84, 84, 4]`` input with the
  JAX weights carried over: 1e-5; its fresh conv kernels spread as
  flax's lecun-normal ones (std within 10%).

``disc_mixed_precision`` (a bf16 disc trunk) is held against what bf16
explains: on the same inputs, the port's distance from the JAX package in
bf16 must be no larger than JAX in bf16 from JAX in f32, for the disc
reward, each ``_disc_loss`` term and each gradient of the disc, under
``add`` and ``amp``; and after a whole bf16-disc ``train_iter`` each
disc parameter tensor is no farther from JAX in bf16 than JAX in bf16 lies from
JAX in f32 (largest and 99th-percentile difference).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.learning import distributions as jdist
from add_gym_tpu.learning.normalizer import DiffNormState as JaxDiffNormState
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.learning import add_agent as port_agent
from add_gym_torch.learning import distributions as tdist
from add_gym_torch.learning import optim
from add_gym_torch.learning.convert import _flax_like_params, from_jax, load_flax_params, load_sgd_state
from add_gym_torch.learning.networks import build_trunk
from add_gym_torch.physics import testing as fx
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 8, 4
SMALL_NET = "fc_2layers_64units"
LR = 1e-4
MINI_JOINTS = ["left_leg_joint", "right_leg_joint"]
MODES = {
    "add": [],
    "amp": ["agent=amp_g1"],
    "none": ["agent=ppo_g1"],
    "sgd": ["agent.optimizer=sgd"],
    "constant": ["agent.actor_std_type=constant"],
    "variable": ["agent.actor_std_type=variable"],
}


def _cfg(load, files, mode, disc_bf16=False):
    cfg = load("train", MODES[mode])
    cfg["robot"]["asset_path"], cfg["task"]["motion_file"] = files["mjcf"], files["clip"]
    if files["mini"]:
        cfg["robot"]["joints"] = [{"match": ".*leg_joint", "tags": ["hip"]}]
        cfg["task"]["motion_joint_order"] = MINI_JOINTS
        cfg["task"]["contact_bodies"] = ["left_leg_link", "right_leg_link"]
    cfg["engine"]["num_envs"] = N
    cfg["agent"].update(steps_per_iter=T, batch_size=2, mixed_precision=False,
                        disc_mixed_precision=disc_bf16, actor_net=SMALL_NET, critic_net=SMALL_NET,
                        disc_net=SMALL_NET)
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
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


class Pair:
    """The JAX agent and the port's on the same fixture, mode and state."""

    def __init__(self, files, mode, disc_bf16=False):
        self.mode = mode
        self.jcfg = _cfg(jax_load_config, files, mode, disc_bf16)
        self.jenv = jax_build_env(self.jcfg)
        self.jagent = jax_build_agent(self.jcfg, self.jenv)
        jts = self.jagent.init_train_state(jax.random.PRNGKey(7))
        rng = np.random.default_rng(11)

        def norm_state(s):
            if isinstance(s, JaxDiffNormState):
                return dataclasses.replace(s, count=jnp.float32(100.0), mean_abs=jnp.asarray(
                    rng.uniform(0.05, 0.5, s.mean_abs.shape), jnp.float32))
            mean = rng.normal(0.0, 0.3, s.mean.shape).astype(np.float32)
            std = rng.uniform(0.5, 2.0, s.mean.shape).astype(np.float32)
            return dataclasses.replace(s, count=jnp.float32(100.0), mean=jnp.asarray(mean),
                                       mean_sq=jnp.asarray(std * std + mean * mean))

        self.jts = dataclasses.replace(
            jts, obs_norm=norm_state(jts.obs_norm), disc_norm=norm_state(jts.disc_norm),
            sampler=dataclasses.replace(jts.sampler, errors=jnp.asarray(
                rng.uniform(0.5, 2.0, jts.sampler.errors.shape), jnp.float32)))
        tcfg = _cfg(load_config, files, mode, disc_bf16)
        self.tenv = build_env(tcfg, device="cpu")
        self.tagent = build_agent(tcfg, self.tenv)

    def port_state(self):
        return from_jax(self.tagent, self.jts)

    def port_traj(self):
        """A port rollout trajectory with every done kind written into it
        (as ``tests/test_torch_train.py``)."""
        ts = self.port_state()
        g = torch.Generator().manual_seed(3)
        es = self.tenv.reset_where(self.tenv.init_state(N), torch.ones(N, dtype=torch.bool),
                                   ts.sampler, generator=g)
        traj = self.tagent.rollout_lean(ts, es, self.tenv.compute_obs(es), T, generator=g)[2]
        done = np.zeros((T, N), np.int32)
        done[0, :4] = [1, 2, 3, 0]
        done[2, 4:7] = [2, 3, 1]
        traj["done"] = torch.as_tensor(done)
        traj["rand_mask"][1, ::3] = 0.0
        # off the sampler's segment boundaries (see tests/test_torch_train.py)
        traj["motion_times"] = traj["motion_times"] + 0.003
        return traj

    def demo_draws(self, key, n):
        """The motion ids and start times JAX's ``fetch_disc_obs_demo``
        draws from ``key`` for ``n`` windows."""
        k1, k2 = jax.random.split(key)
        ids = self.jenv.motion.sample_motions(k1, n)
        return np.asarray(ids), np.asarray(self.jenv._sample_times(k2, ids, self.jts.sampler))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    return dict(
        g1=dict(mini=False, mjcf=fx.write_g1_fixture(str(d)),
                clip=fx.write_motion_csv(str(d / "clip.motion"), seed=5, num_frames=120)),
        mini=dict(mini=True, mjcf=fx.write_mini_mjcf(str(d)),
                  clip=fx.write_motion_csv(str(d / "mini.motion"), seed=3, num_frames=90,
                                           joint_order=MINI_JOINTS, height=0.65)),
    )


@pytest.fixture(scope="module")
def pairs(files):
    cache = {}

    def get(fixture, mode, disc_bf16=False):
        key = (fixture, mode, disc_bf16)
        if key not in cache:
            cache[key] = Pair(files[fixture], mode, disc_bf16)
        return cache[key]

    return get


def _jax_perms(key, epochs, nblk):
    return [np.asarray(jax.random.permutation(k, nblk)) for k in jax.random.split(key, epochs)]


def _param_deltas(net, jax_params):
    want = _flax_like_params(net, jax_params)
    return np.concatenate([(p.detach() - w).abs().flatten().numpy()
                           for p, w in zip(net.parameters(), want)])


def _assert_params_close(net, jax_params, what, bulk=0.05):
    """All within 2 lr of JAX's, and 99% within ``bulk`` lr."""
    diffs = _param_deltas(net, jax_params)
    assert diffs.max() <= 2 * LR, f"{what}: max |delta| {diffs.max() / LR:.3f} lr"
    assert np.mean(diffs > bulk * LR) <= 0.01, (
        f"{what}: {np.mean(diffs > bulk * LR):.4f} of the elements differ by > {bulk} lr")


def _jax_data(pair, traj, key):
    return jax.jit(pair.jagent.build_train_data)(pair.jts, to_jnp(traj), key)


def _batch(pair, jdata):
    rows = np.random.default_rng(1).permutation(T * N)[:16]
    return {k: jnp.asarray(jdata[k]).reshape((T * N,) + jdata[k].shape[2:])[rows]
            for k in port_agent.MODE_FIELDS[pair.tagent.cfg.disc_mode]}


# ------------------------------------------------------------ agent init


def test_unknown_modes_raise(files):
    tenv = build_env(_cfg(load_config, files["mini"], "add"), device="cpu")
    for key, bad in (("disc_mode", "gail"), ("optimizer", "rmsprop"), ("actor_std_type", "learned")):
        cfg = _cfg(load_config, files["mini"], "add")
        cfg["agent"][key] = bad
        with pytest.raises(ValueError, match=key):
            build_agent(cfg, tenv)


# ------------------------------------------------------------ train data


@pytest.mark.parametrize("mode", ["amp", "none"])
def test_build_train_data(pairs, mode):
    pair = pairs("g1", mode)
    traj = pair.port_traj()
    key = jax.random.PRNGKey(21)
    jts, jdata, jinfo = _jax_data(pair, traj, key)
    tts, tdata, tinfo = pair.tagent.build_train_data(pair.port_state(), traj,
                                                     demo_draws=pair.demo_draws(key, T * N))
    fields = {"amp": ("disc_in", "disc_pos", "disc_obs_demo"), "none": ()}[mode]
    for k in ("reward", "tar_val", "adv") + fields:
        np.testing.assert_allclose(to_np(tdata[k]), to_np(jdata[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert ("disc_in" in tdata) == ("disc_in" in jdata) == (mode != "none")
    np.testing.assert_allclose(tts.sampler.errors.numpy(), np.asarray(jts.sampler.errors),
                               rtol=1e-5, atol=1e-5)
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(to_np(tinfo[k]), to_np(jinfo[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if mode == "amp":
        # the fresh windows are not the aligned ones the rollout recorded
        assert np.abs(to_np(tdata["disc_obs_demo"]) - to_np(traj["disc_obs_demo"])).max() > 0.1
    else:
        assert float(jinfo["disc_reward_mean"]) == float(tinfo["disc_reward_mean"]) == 0.0
        np.testing.assert_allclose(to_np(tdata["reward"]), to_np(traj["reward"]), rtol=1e-6)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("mode", ["amp", "none", "constant", "variable"])
def test_loss_terms_and_gradients(pairs, mode):
    pair = pairs("g1", mode)
    _, jdata, _ = _jax_data(pair, pair.port_traj(), jax.random.PRNGKey(22))
    batch = _batch(pair, jdata)
    (jloss, jinfo), jgrads = jax.jit(jax.value_and_grad(pair.jagent._loss, has_aux=True))(
        pair.jts.params, batch)
    ts = pair.port_state()
    tloss, tinfo = pair.tagent._loss(ts.params, {k: torch.as_tensor(np.array(v))
                                                 for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, list(ts.params.parameters()))

    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want = _flax_like_params(ts.params, jgrads)
    names = [n for n, _ in ts.params.named_parameters()]
    for name, g, w in zip(names, tgrads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()), err_msg=name)
    grad = dict(zip(names, tgrads))
    if mode == "none":
        assert not any(n.startswith("disc") for n in names) and "disc_loss" not in tinfo
    if mode == "amp":
        assert float(jinfo["disc_grad_penalty"]) > 0.0
    if mode in ("constant", "variable"):
        head = "actor_logstd" if mode == "constant" else "actor_logstd_head.bias"
        assert float(grad[head].abs().max()) > 0.0


# --------------------------------------------------------------- optimizer


def test_clip_sgd_step_matches_optax(pairs):
    import optax

    pair = pairs("g1", "sgd")
    params = pair.jts.params
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0.0, 0.5, p.shape), jnp.float32), params)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(LR, momentum=0.9))
    jstate = opt.init(params)
    net = pair.port_state().params
    tstate = optim.init_sgd(net.parameters())
    for _ in range(2):                    # the second step runs on a non-zero trace
        upd, jstate = opt.update(grads, jstate, params)
        params = optax.apply_updates(params, upd)
        tstate = optim.clip_sgd_step(list(net.parameters()), _flax_like_params(net, grads),
                                     tstate, LR, 1.0, 0.9)
    for p, w in zip(net.parameters(), _flax_like_params(net, params)):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(tstate.trace, load_sgd_state(net, jstate).trace):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)
    assert max(float(t.abs().max()) for t in tstate.trace) > 0.0


# -------------------------------------------------------------- train_iter


def _train_iter_both(pair):
    """One train_iter of each package from the same state and draws; returns
    (JAX outputs, port outputs, the port state before)."""
    jenv, jagent, tenv, tagent, jts = pair.jenv, pair.jagent, pair.tenv, pair.tagent, pair.jts
    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(N), jnp.ones(N, bool), jts.sampler)
    ep_time = np.zeros(N, np.float32)
    ep_time[:2] = pair.jcfg["task"]["max_episode_length"] - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    jobs = jenv.compute_obs(jes)
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, N)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)

    tts = pair.port_state()
    tes = tenv.reset_where(tenv.init_state(N), torch.ones(N, dtype=torch.bool), tts.sampler,
                           draws=(np.asarray(r_ids), np.asarray(r_times)))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    tobs = tenv.compute_obs(tes)

    key = jax.random.PRNGKey(9)
    k_roll, k_data, k_upd = jax.random.split(key, 3)
    k_noise, k_bern, k_ids, k_times, _ = jax.random.split(k_roll, 5)
    noise = jax.random.normal(k_noise, (T, N, jenv.num_dofs))
    bern = jax.random.bernoulli(k_bern, jagent._exp_prob(jts.sample_count), (T, N, 1))
    ids_f = jenv.motion.sample_motions(k_ids, T * N)
    times_f = jenv._sample_times(k_times, ids_f, jts.sampler).reshape(T, N)
    draws = tuple(np.asarray(x, np.float32 if x.dtype == bool else x.dtype)
                  for x in (noise, bern, ids_f.reshape(T, N), times_f))
    nblk = T * N // port_agent.pick_shuffle_block(T * N, 2, T * N // 2, N)
    perms = _jax_perms(k_upd, tagent.cfg.update_epochs, nblk)
    demo = pair.demo_draws(k_data, T * N) if pair.mode == "amp" else None

    jout = jagent.train_iter(jts, jes, jobs, key)
    tout = tagent.train_iter(tts, tes, tobs, draws=draws, perms=perms, demo_draws=demo)
    return jout, tout


@pytest.mark.parametrize("mode", ["amp", "none", "sgd", "constant", "variable"])
def test_train_iter_matches_jax(pairs, mode):
    pair = pairs("mini", mode)
    (jts2, jes2, jobs2, jinfo), (tts2, tes2, tobs2, tinfo) = _train_iter_both(pair)
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(to_np(tinfo[k]), to_np(jinfo[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert float(jinfo["done_frac"]) > 0.0
    _assert_params_close(tts2.params, jts2.params, "params")
    for name in ("obs_norm", "disc_norm"):
        jn, tn = getattr(jts2, name), getattr(tts2, name)
        assert type(tn).__name__ == type(jn).__name__
        for f in port_agent._norm_dict(tn):
            np.testing.assert_allclose(to_np(getattr(tn, f)), to_np(getattr(jn, f)), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name}.{f}")
    np.testing.assert_allclose(to_np(tts2.sampler.errors), to_np(jts2.sampler.errors),
                               rtol=1e-4, atol=1e-4)
    assert int(tts2.sample_count) == int(jts2.sample_count) == T * N
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tes2.motion_ids.numpy(), np.asarray(jes2.motion_ids))
    if mode == "amp":                     # agent and fresh demo obs: 2 T N samples
        assert float(tts2.disc_norm.count) == 100.0 + 2 * T * N
    if mode == "sgd":
        got = tts2.opt_state.trace
        want = load_sgd_state(tts2.params, jts2.opt_state).trace
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))


class _TwoEqualRanks:
    """A ``Dist`` stand-in for two ranks that hold the same data: every sum
    over the ranks doubles."""

    world_size = 2

    def all_reduce_sum(self, x):
        return 2.0 * x


def test_amp_disc_norm_merges_global_sums(pairs):
    """AMP's disc normalizer merges the sums of every rank's agent and
    fresh demo obs (``update_normalizer_from_stats``): with two ranks that
    hold the same data, JAX's ``update_normalizer`` over the four blocks
    together, at 1e-6."""
    import copy

    from add_gym_tpu.learning import normalizer as jnorm

    pair = pairs("g1", "amp")          # (JAX's train_iter donates its pair's state)
    agent = copy.copy(pair.tagent)
    agent.dist = _TwoEqualRanks()
    rng = np.random.default_rng(8)
    d = pair.tenv.disc_obs_dim()
    data = {k: rng.normal(0.3, 1.5, (T, N, d)).astype(np.float32)
            for k in ("disc_obs", "disc_obs_demo")}
    new, fields = agent._disc_norm_update(pair.port_state().disc_norm,
                                          {k: torch.as_tensor(v) for k, v in data.items()})
    both = np.concatenate([data["disc_obs"], data["disc_obs_demo"]] * 2)
    want = jnorm.update_normalizer(pair.jts.disc_norm, jnp.asarray(both))
    assert fields == ("count", "mean", "mean_sq")
    assert float(new.count) == float(want.count) == 100.0 + 4 * T * N
    for f in ("mean", "mean_sq"):
        np.testing.assert_allclose(getattr(new, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


# ------------------------------------------------------ disc mixed precision


def _disc_outputs(pair, batch, params):
    """The disc reward on the batch's negatives, each ``_disc_loss`` term
    and the disc's gradients of the disc loss, as numpy (JAX when
    ``params`` is a flax tree, else the port)."""
    if isinstance(params, dict):
        agent, net = pair.jagent, pair.tagent.init_train_state().params
        reward = jax.jit(agent._disc_reward_from_input)(params, batch["disc_in"])
        (_, info), grads = jax.jit(jax.value_and_grad(agent._disc_loss, has_aux=True))(
            params, batch)
        grads = {n: to_np(g) for (n, _), g in zip(net.named_parameters(),
                                                  _flax_like_params(net, grads))}
        return to_np(reward), {k: to_np(v) for k, v in info.items()}, grads
    agent = pair.tagent
    tb = {k: torch.as_tensor(np.array(v, np.float32)) for k, v in batch.items()}
    if agent.cfg.disc_mixed_precision:
        tb = {k: v.to(torch.bfloat16) if k.startswith("disc") else v for k, v in tb.items()}
    with torch.no_grad():
        reward = agent._disc_reward_from_input(params, tb["disc_in"])
    loss, info = agent._disc_loss(params, tb)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)
    grads = {n: (g if g is not None else torch.zeros_like(p)).numpy()
             for n, g, p in zip(names, grads, params.parameters())}
    return to_np(reward), {k: to_np(v) for k, v in info.items()}, grads


@pytest.mark.parametrize("what", ["reward", "loss_terms", "gradients"])
@pytest.mark.parametrize("mode", ["add", "amp"])
def test_disc_mixed_precision_within_bf16(pairs, mode, what):
    f32, bf16 = pairs("g1", mode), pairs("g1", mode, disc_bf16=True)
    _, jdata, _ = _jax_data(f32, f32.port_traj(), jax.random.PRNGKey(23))
    batch = _batch(f32, jdata)
    jbatch = {k: v.astype(jnp.bfloat16) if k.startswith("disc") else v for k, v in batch.items()}
    j32 = _disc_outputs(f32, batch, f32.jts.params)
    j16 = _disc_outputs(bf16, jbatch, bf16.jts.params)
    t16 = _disc_outputs(bf16, batch, bf16.port_state().params)
    idx = {"reward": 0, "loss_terms": 1, "gradients": 2}[what]
    got, want, f32_out = t16[idx], j16[idx], j32[idx]
    items = {"x": (got, want, f32_out)} if what == "reward" else {
        k: (got[k], want[k], f32_out[k]) for k in want
        if not k.endswith("_acc") and (what == "loss_terms" or k.startswith("disc"))}
    errs = {k: (float(np.abs(a - b).max()), float(np.abs(b - c).max()))
            for k, (a, b, c) in items.items()}
    assert max(e[1] for e in errs.values()) > 0.0           # bf16 does round
    for k, (port_err, bf16_err) in errs.items():
        assert port_err <= bf16_err, (f"{what} {k}: port vs JAX-bf16 {port_err:.3e} > "
                                      f"JAX-bf16 vs JAX-f32 {bf16_err:.3e}")


def test_disc_mixed_precision_train_iter(pairs):
    """A whole bf16-disc ``train_iter``: the infos within 2e-2 of JAX's in
    bf16, and each disc parameter tensor no farther from JAX's in bf16
    (largest and 99th-percentile difference) than JAX in bf16 lies from
    JAX in f32; the f32 actor and critic within the f32 bound (2 lr, 99%
    within 0.05 lr).
    Adam's sign-like steps turn bf16's gradient noise into parameter
    differences of several lr over the 10 steps (on this input the disc
    trunk: 3.3 lr port / bf16 JAX against 8.4 lr bf16 / f32 JAX), so the
    lr-unit bound of the f32 tests does not apply."""
    (j16, _, _, jinfo), (t16, _, _, tinfo) = _train_iter_both(pairs("mini", "add", True))
    (j32, _, _, _), _ = _train_iter_both(pairs("mini", "add"))
    for k in jinfo:
        np.testing.assert_allclose(to_np(tinfo[k]), to_np(jinfo[k]), rtol=2e-2, atol=2e-2,
                                   err_msg=k)
    net = t16.params
    moved = 0.0
    for (name, p), a, b in zip(net.named_parameters(), _flax_like_params(net, j16.params),
                               _flax_like_params(net, j32.params)):
        port, yard = (p.detach() - a).abs().numpy(), (a - b).abs().numpy()
        if not name.startswith("disc"):      # f32 networks: the f32 bound
            assert port.max() <= 2 * LR and np.quantile(port, 0.99) <= 0.05 * LR, name
            continue
        for stat in (np.max, lambda x: np.quantile(x, 0.99)):
            assert stat(port) <= stat(yard), (
                f"{name}: port vs JAX-bf16 {stat(port) / LR:.3f} lr > JAX-bf16 vs JAX-f32 "
                f"{stat(yard) / LR:.3f} lr")
        print(f"{name}: largest difference port vs JAX-bf16 {port.max() / LR:.3f} lr, "
              f"JAX-bf16 vs JAX-f32 {yard.max() / LR:.3f} lr")
        moved = max(moved, float(yard.max()))
    assert moved > LR                          # bf16 does move the disc


# -------------------------------------------------- categorical and conv trunk


LOGITS = np.concatenate([
    np.asarray([[2.0, 0.0, -1.0, 0.5, 0.0], [0.0, 3.0, 0.0, -2.0, 1.0]], np.float32),
    np.random.default_rng(4).normal(0.0, 2.0, (6, 5)).astype(np.float32),
])


@pytest.mark.parametrize("fn", ["mode", "log_prob", "entropy", "param_reg", "sample"])
def test_categorical_head(fn):
    tl = torch.as_tensor(LOGITS)
    if fn == "sample":
        g = torch.Generator().manual_seed(0)
        x = tdist.categorical_sample(tl.expand(4000, *tl.shape), g)
        assert x.shape == (4000, len(LOGITS)) and x.min() >= 0 and x.max() < LOGITS.shape[1]
        freq = np.stack([(x.numpy() == k).mean(0) for k in range(LOGITS.shape[1])], -1)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(LOGITS), -1))
        np.testing.assert_allclose(freq, probs, atol=0.03)
        return
    if fn == "mode":
        got, want = tdist.categorical_mode(tl), jdist.categorical_mode(jnp.asarray(LOGITS))
    elif fn == "log_prob":
        x = np.random.default_rng(5).integers(0, LOGITS.shape[1], len(LOGITS))
        got = tdist.categorical_log_prob(tl, torch.as_tensor(x))
        want = jdist.categorical_log_prob(jnp.asarray(LOGITS), jnp.asarray(x))
    else:
        got = getattr(tdist, f"categorical_{fn}")(tl)
        want = getattr(jdist, f"categorical_{fn}")(jnp.asarray(LOGITS))
    if fn == "mode":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:                                  # reductions in another order: 1-2 ulp
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_cnn_trunk_forward():
    from add_gym_tpu.learning.networks import build_trunk as jax_build_trunk

    x = np.random.default_rng(6).uniform(0.0, 1.0, (2, 84, 84, 4)).astype(np.float32)
    jnet = jax_build_trunk("cnn_3conv_1fc_0")
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.actor_trunk = build_trunk("cnn_3conv_1fc_0", (84, 84, 4))
    load_flax_params(holder, {"params": {"actor_trunk": jparams["params"]}})
    got = holder.actor_trunk(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 512) and float(np.abs(want).max()) > 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # fresh conv kernels have flax's spread: std within 10%, bounded at 2 sigma
    fresh = build_trunk("cnn_3conv_1fc_0", (84, 84, 4), torch.Generator().manual_seed(0))
    for i, conv in enumerate(fresh.convs):
        jk = np.asarray(jparams["params"][f"Conv_{i}"]["kernel"])
        w = conv.weight.detach().numpy()
        assert abs(w.std() / jk.std() - 1.0) < 0.1, i
        assert np.abs(w).max() <= np.abs(jk).max() * 1.1 and not conv.bias.any()
    with pytest.raises(ValueError, match="H, W, C"):
        build_trunk("cnn_3conv_1fc_0", 264)
