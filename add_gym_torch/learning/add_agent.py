"""ADD agent: PPO + adversarial differential discriminator, and the AMP
and plain-PPO agents.

Counterpart of ``add_gym_tpu/learning/add_agent.py``: ``AgentConfig``,
``TrainState`` (with the optimizer's state), network and normalizer init,
the evaluation rollouts (``rollout``, ``eval_rollout`` and the video's
``eval_rollout_states``) and one training iteration, ``train_iter``:

1. ``rollout_lean``: the train rollout (bf16 actor under mixed precision,
   presampled action noise, reset and domain-randomization draws);
2. ``build_train_data``: the disc reward, critic values, TD(lambda)
   returns, masked advantage normalization and the sampler's error update;
3. ``update_model``: epochs of shuffled minibatches of the PPO actor loss,
   the critic loss and the disc loss with its gradient penalty (a double
   backward), each followed by a clipped Adam or SGD step
   (``learning/optim.py``);
4. the obs and disc normalizer updates, gated by ``normalizer_samples``.

``disc_mode`` picks the agent, as in the JAX package:

* ``add``: the disc sees normalized demo-agent obs *differences*
  (``DiffNormState``), the positive is the zero difference and the
  gradient penalty ``(|grad| - 1)^2`` is taken on the negative input;
* ``amp``: the disc sees normalized obs (a running mean/std
  ``NormState`` over agent and demo obs); the positives are fresh demo
  windows fetched for every sample in ``build_train_data`` and the
  penalty ``|grad|^2`` is taken on them;
* ``none``: plain PPO, no disc parameters, reward ``task_reward_weight``
  times the task reward.

``actor_std_type`` is ``fixed`` (the agent's constant ``log(action_std)``),
``constant`` (a learned parameter) or ``variable`` (a head on the actor
trunk); ``optimizer`` is ``adam`` or ``fused_adam`` (one step) or ``sgd``.

Every random draw can be injected (rollout draws, minibatch permutations),
so the parity tests feed the port the JAX package's draws.  The network
parameters are updated in place (the JAX package donates its buffers).

Data parallelism (``dist``, a ``parallel.mesh.Dist`` of several ranks,
each holding its shard of the envs) makes global what GSPMD makes global
in the JAX package: each rank reduces sums and counts over the ranks, never
local means (the rollout's obs-normalizer statistics, the disc diff
normalizer's sum of |x|, the advantage moments in two passes, the
sampler's per-segment sums, the infos), draws its own minibatch
permutations, and averages the gradients over the ranks once per
minibatch, before the clip and the Adam step.  Every rank then holds the
same parameters bit for bit.  With one rank every reduction is the
identity.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from add_gym_torch.envs.done import DoneFlags
from add_gym_torch.envs.domain_rand import DR_KEYS
from add_gym_torch.envs.imitation import EnvState, ImitationEnv, to_device
from add_gym_torch.learning import distributions as dist
from add_gym_torch.learning import normalizer as norm
from add_gym_torch.learning import optim
from add_gym_torch.learning import sampler as sampler_mod
from add_gym_torch.learning.networks import NET_REGISTRY, STD_TYPES, ADDNet
from add_gym_torch.parallel.mesh import Dist
from add_gym_torch.utils.trace import span

DISC_MODES = ("add", "amp", "none")
OPTIMIZERS = ("adam", "fused_adam", "sgd")

# the minibatch fields the losses read (update_model gathers only these):
# UPDATE_FIELDS under "add", MODE_FIELDS for each disc_mode
_PPO_FIELDS = ("norm_obs", "norm_a", "a_logp", "tar_val", "adv", "rand_mask")
UPDATE_FIELDS = _PPO_FIELDS + ("disc_in",)
MODE_FIELDS = {"add": UPDATE_FIELDS, "amp": UPDATE_FIELDS + ("disc_pos",), "none": _PPO_FIELDS}


@dataclass(frozen=True)
class AgentConfig:
    """Hyperparameters (configs/agent/add_g1.yaml + train.yaml)."""

    discount: float = 0.99
    td_lambda: float = 0.95
    steps_per_iter: int = 32
    update_epochs: int = 5
    batch_size: int = 4
    ppo_clip_ratio: float = 0.2
    norm_adv_clip: float = 4.0
    action_bound_weight: float = 10.0
    action_entropy_weight: float = 0.0
    action_reg_weight: float = 0.0
    critic_loss_weight: float = 1.0
    learning_rate: float = 1e-4
    grad_clip: float = 1.0
    optimizer: str = "adam"
    momentum: float = 0.9
    disc_loss_weight: float = 0.5
    disc_logit_reg: float = 0.01
    disc_grad_penalty: float = 20.0
    disc_weight_decay: float = 1e-4
    disc_reward_scale: float = 2.0
    task_reward_weight: float = 0.0
    disc_reward_weight: float = 1.0
    action_std: float = 0.05
    actor_std_type: str = "fixed"
    exp_prob: float = 1.0
    exp_prob_end: float = 1.0
    exp_anneal_samples: float = float("inf")
    normalizer_samples: float = 1e8
    disc_mode: str = "add"
    actor_net: str = "fc_3layers_1024units"
    critic_net: str = "fc_3layers_1024units"
    disc_net: str = "fc_2layers_1024units"
    actor_init_output_scale: float = 0.01
    # bf16 actor/critic trunk matmuls with f32 master weights and f32 heads
    mixed_precision: bool = False
    disc_mixed_precision: bool = False
    minibatch_blocks: str = "auto"


@dataclass
class TrainState:
    params: ADDNet
    opt_state: optim.AdamState | optim.SGDState
    obs_norm: norm.NormState
    disc_norm: norm.DiffNormState | norm.NormState   # NormState under "amp"
    sampler: sampler_mod.SamplerState
    sample_count: torch.Tensor  # [] int


def _norm_dict(n) -> dict:
    """A normalizer's tensors by field name (either kind)."""
    if isinstance(n, norm.NormState):
        return dict(count=n.count, mean=n.mean, mean_sq=n.mean_sq)
    return dict(count=n.count, mean_abs=n.mean_abs)


def _opt_dict(o) -> dict:
    """The optimizer's tensors: Adam's step count and moments, or SGD's traces."""
    if isinstance(o, optim.SGDState):
        return dict(opt_trace=list(o.trace))
    return dict(opt_count=o.count, opt_mu=list(o.mu), opt_nu=list(o.nu))


def train_state_dict(ts: TrainState) -> dict:
    """The train state as a dict of tensors (what a checkpoint holds)."""
    return dict(
        params=ts.params.state_dict(),
        **_opt_dict(ts.opt_state),
        obs_norm=_norm_dict(ts.obs_norm),
        disc_norm=_norm_dict(ts.disc_norm),
        sampler_errors=ts.sampler.errors,
        sample_count=ts.sample_count,
    )


def state_tensors(d) -> list:
    """Every tensor of a nested dict / list such as a
    :func:`train_state_dict`, in a fixed order."""
    if isinstance(d, dict):
        return [t for k in sorted(d) for t in state_tensors(d[k])]
    if isinstance(d, (list, tuple)):
        return [t for x in d for t in state_tensors(x)]
    return [torch.as_tensor(d)]


def state_digest(ts: TrainState) -> str:
    """SHA-256 of every tensor of the train state (network, optimizer
    state, normalizers, sampler, sample count): equal digests mean equal
    bits."""
    h = hashlib.sha256()
    for t in state_tensors(train_state_dict(ts)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def load_train_state_dict(ts: TrainState, d: dict) -> TrainState:
    """``ts`` holding the values of ``d`` (a :func:`train_state_dict`) on
    ``ts``'s device; the network is loaded in place.  Raises on a shape
    that does not fit, and where ``d`` holds another optimizer's state or
    another kind of disc normalizer than ``ts``."""
    dev = ts.sample_count.device
    t = lambda x, like: torch.as_tensor(x).to(device=dev, dtype=like.dtype)
    ts.params.load_state_dict(d["params"])
    params = list(ts.params.parameters())
    want = _opt_dict(ts.opt_state)
    if set(want) - set(d):
        raise ValueError(f"the checkpoint's optimizer state has {sorted(k for k in d if k.startswith('opt_'))}, "
                         f"this agent's {sorted(want)}")
    per_param = {k: v for k, v in want.items() if isinstance(v, list)}
    for k in per_param:
        if len(d[k]) != len(params):
            raise ValueError(f"checkpoint has {len(d[k])} {k} tensors, the network "
                             f"{len(params)} parameters")
    loaded = {k: [t(m, p).reshape(p.shape) for m, p in zip(d[k], params)] for k in per_param}
    if isinstance(ts.opt_state, optim.SGDState):
        opt_state = optim.SGDState(trace=loaded["opt_trace"])
    else:
        opt_state = optim.AdamState(count=t(d["opt_count"], ts.opt_state.count),
                                    mu=loaded["opt_mu"], nu=loaded["opt_nu"])
    if set(d["disc_norm"]) != set(_norm_dict(ts.disc_norm)):
        raise ValueError(f"the checkpoint's disc normalizer has {sorted(d['disc_norm'])}, this "
                         f"agent's {sorted(_norm_dict(ts.disc_norm))} (another disc_mode)")
    return replace(
        ts,
        opt_state=opt_state,
        obs_norm=replace(ts.obs_norm, **{k: t(v, ts.obs_norm.mean) for k, v in d["obs_norm"].items()}),
        disc_norm=replace(ts.disc_norm, **{k: t(v, ts.disc_norm.count)
                                           for k, v in d["disc_norm"].items()}),
        sampler=sampler_mod.SamplerState(errors=t(d["sampler_errors"], ts.sampler.errors)),
        sample_count=t(d["sample_count"], ts.sample_count),
    )


class ADDAgent:
    """Binds env + networks + config into the acting functions."""

    def __init__(self, env: ImitationEnv, cfg: AgentConfig,
                 generator: torch.Generator | None = None, dist: Dist | None = None):
        for key, allowed in (("disc_mode", DISC_MODES), ("optimizer", OPTIMIZERS),
                             ("actor_std_type", STD_TYPES)):
            if getattr(cfg, key) not in allowed:
                raise ValueError(f"{key} must be one of {allowed}, got {getattr(cfg, key)!r}")
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.dist = dist if dist is not None else Dist(device=env.device)
        self.logstd = float(np.log(cfg.action_std))
        self.generator = generator
        # action normalizer from the action space
        self.a_mean = torch.as_tensor(
            0.5 * (env.action_high + env.action_low), dtype=torch.float32, device=self.device)
        self.a_std = torch.as_tensor(
            0.5 * (env.action_high - env.action_low), dtype=torch.float32, device=self.device)

    def net_params_by_trunk(self) -> dict:
        """Matmul parameter counts (the sum of in x out over the layers) of
        the actor, the critic and the disc (0 without one): a sample's
        matmul operations are 2x these forward and 4x backward."""
        env, cfg = self.env, self.cfg

        def mm(in_dim, widths, out_dim):
            tot, d = 0, in_dim
            for w in widths:
                tot, d = tot + d * w, w
            return tot + d * out_dim

        return dict(
            actor=mm(env.obs_dim(), NET_REGISTRY[cfg.actor_net], env.num_dofs),
            critic=mm(env.obs_dim(), NET_REGISTRY[cfg.critic_net], 1),
            disc=(mm(env.disc_obs_dim(), NET_REGISTRY[cfg.disc_net], 1)
                  if cfg.disc_mode != "none" else 0),
        )

    # ------------------------------------------------------------------ init

    def init_train_state(self, generator: torch.Generator | None = None) -> TrainState:
        g = generator if generator is not None else self.generator
        cfg, env = self.cfg, self.env
        obs_dim, disc_dim = env.obs_dim(), env.disc_obs_dim()
        net = ADDNet(
            obs_dim, disc_dim, env.num_dofs,
            actor_net=cfg.actor_net, critic_net=cfg.critic_net, disc_net=cfg.disc_net,
            actor_init_output_scale=cfg.actor_init_output_scale,
            enable_disc=cfg.disc_mode != "none", std_type=cfg.actor_std_type,
            init_logstd=self.logstd, generator=g, device=self.device,
        )
        # "add" (and "none") normalize obs differences by mean |x|, "amp"
        # the disc obs by a running mean/std
        if cfg.disc_mode == "amp":
            disc_norm = norm.init_normalizer((disc_dim,), device=self.device)
        else:
            disc_norm = norm.init_diff_normalizer((disc_dim,), device=self.device)
        opt_init = optim.init_sgd if cfg.optimizer == "sgd" else optim.init_adam
        return TrainState(
            params=net,
            opt_state=opt_init(net.parameters()),
            obs_norm=norm.init_normalizer((obs_dim,), device=self.device),
            disc_norm=disc_norm,
            sampler=sampler_mod.init_sampler(
                env.motion.num_motions, env.task.sampler_num_segments, self.device),
            sample_count=torch.zeros((), dtype=torch.int64, device=self.device),
        )

    # ------------------------------------------------------- mixed precision

    def _trunk_dtype(self):
        return torch.bfloat16 if self.cfg.mixed_precision else None

    def _actor(self, net: ADDNet, norm_obs):
        """Actor ``(mean, logstd)`` at the configured precision (bf16 trunk,
        f32 heads); ``logstd`` is None under ``actor_std_type`` fixed."""
        return net.actor(norm_obs, self._trunk_dtype())

    def _logstd(self, mean, logstd):
        """The net's ``logstd``, or the fixed one shaped like ``mean``."""
        return torch.full_like(mean, self.logstd) if logstd is None else logstd

    def _critic(self, net: ADDNet, norm_obs):
        return net.critic(norm_obs, self._trunk_dtype())

    def _disc(self, net: ADDNet, x):
        """Disc logits at the configured precision: one function for the
        reward, the BCE terms and the gradient penalty."""
        return net.disc(x, torch.bfloat16 if self.cfg.disc_mixed_precision else None)

    # --------------------------------------------------------------- acting

    def _exp_prob(self, sample_count) -> float:
        cfg = self.cfg
        if not math.isfinite(cfg.exp_anneal_samples):
            return cfg.exp_prob
        l = min(max(float(sample_count) / cfg.exp_anneal_samples, 0.0), 1.0)
        return (1.0 - l) * cfg.exp_prob + l * cfg.exp_prob_end

    def _global_sum(self, *xs):
        """Each tensor of ``xs`` summed over the ranks, in one collective
        over an f32 buffer (the same values with one rank)."""
        flat = torch.cat([torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1)
                          for x in xs])
        flat = self.dist.all_reduce_sum(flat)
        out, i = [], 0
        for x in xs:
            n = torch.as_tensor(x).numel()
            out.append(flat[i:i + n].reshape(torch.as_tensor(x).shape))
            i += n
        return tuple(out) if len(out) > 1 else out[0]

    def _decide_action(self, net: ADDNet, obs_norm, obs, train: bool, exp_prob=None,
                       noise=None, bern=None, generator: torch.Generator | None = None):
        """Action from the actor: with ``train`` the rand-action-mask
        exploration (Gaussian noise on the envs a Bernoulli(``exp_prob``)
        picks), else the mean.  ``noise`` [N, nd] and ``bern`` [N, 1]
        replace the draws.  Returns (action, norm_a, a_logp, rand_mask)."""
        g = generator if generator is not None else self.generator
        norm_obs = norm.normalize(obs_norm, obs)
        mean, logstd = self._actor(net, norm_obs)
        logstd = self._logstd(mean, logstd)
        if train:
            if noise is None:
                noise = torch.randn(mean.shape, generator=g, device=self.device)
            if bern is None:
                p = self.cfg.exp_prob if exp_prob is None else exp_prob
                bern = torch.bernoulli(torch.full((mean.shape[0], 1), p, device=self.device),
                                       generator=g)
            norm_a = torch.where(bern == 1.0, mean + torch.exp(logstd) * noise, mean)
            rand_mask = bern[:, 0]
        else:
            norm_a = mean
            rand_mask = torch.zeros(mean.shape[0], device=self.device)
        a_logp = dist.log_prob(mean, logstd, norm_a)
        action = norm_a * self.a_std + self.a_mean
        return action, norm_a, a_logp, rand_mask

    def sample_rollout_draws(self, ts: TrainState, num_envs: int, num_steps: int,
                             generator: torch.Generator | None = None):
        """Presampled rollout randomness: (noise [T,N,nd], bern [T,N,1],
        reset ids [T,N], reset times [T,N]), and with domain randomization
        on a fifth entry, the reset perturbations (a dict of [T,N])."""
        g = generator if generator is not None else self.generator
        env, dev = self.env, self.device
        T, N = num_steps, num_envs
        noise = torch.randn((T, N, env.num_dofs), generator=g, device=dev)
        p = torch.full((T, N, 1), self._exp_prob(ts.sample_count), device=dev)
        bern = torch.bernoulli(p, generator=g)
        ids, times = env.sample_resets(T * N, ts.sampler, g)
        draws = (noise, bern, ids.reshape(T, N), times.reshape(T, N))
        if env.dr.enabled:
            dr_f = env.sample_dr(T * N, g)
            draws += ({k: v.reshape(T, N) for k, v in dr_f.items()},)
        return draws

    @torch.no_grad()
    def rollout_lean(self, ts: TrainState, env_state: EnvState, obs, num_steps: int,
                     generator: torch.Generator | None = None, draws=None):
        """Train rollout: ``num_steps`` control steps with masked resets.

        Records normalized obs (bf16 under mixed precision), the normalized
        action, its log-prob and the disc obs: under ``amp`` the agent's and
        the aligned demo's (``disc_obs``, ``disc_obs_demo``), else only
        their difference (``disc_diff``, all that ``add`` and ``none``
        read); and accumulates the obs-normalizer statistics over the
        acting obs.  ``draws`` =
        (noise, bern, ids, times[, dr_f]) replaces the presampled randomness
        (the parity tests inject the JAX package's draws); ``dr_f``, the
        reset perturbations of domain randomization, is a dict of [T, N].

        The steps run inside ``env.graphed_steps()``: on the card the env's
        control step is one CUDA graph, captured at the first step and
        replayed at the others.

        Returns ``(env_state, obs, traj, obs_stats)``: traj tensors are
        [T, N, ...]; obs_stats = (count, sum[obs_dim], sum_sq[obs_dim]).
        """
        env, cfg, dev = self.env, self.cfg, self.device
        N = obs.shape[0]
        with span("rollout.draws"):
            if draws is None:
                draws = self.sample_rollout_draws(ts, N, num_steps, generator)
            noise, bern, ids_f, times_f = draws[:4]
            noise, bern, times_f = (to_device(x, dev, torch.float32)
                                    for x in (noise, bern, times_f))
            ids_f = to_device(ids_f, dev, torch.int64)
            if len(draws) > 4:
                dr_f = {k: to_device(draws[4][k], dev, torch.float32) for k in DR_KEYS}
            elif env.dr.enabled:
                raise ValueError("domain randomization is on: draws need a fifth entry, dr_f")
            else:
                dr_f = {k: v.expand(num_steps, N) for k, v in env.sample_dr(N).items()}
            out_dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
            net = ts.params

            aux = env.motion_aux(env_state)
            count = torch.zeros((), device=dev)
            s1 = torch.zeros(obs.shape[-1], device=dev)
            s2 = torch.zeros(obs.shape[-1], device=dev)
            # the fixed std is one constant for the whole rollout; a learned
            # one comes from the net at every step
            fixed_logstd = (torch.full((N, env.num_dofs), self.logstd, device=dev)
                            if cfg.actor_std_type == "fixed" else None)
        steps = []
        with env.graphed_steps():
            for t in range(num_steps):
                with span("rollout.step"):
                    with span("policy"):
                        norm_obs = norm.normalize(ts.obs_norm, obs)
                        mean, logstd = self._actor(net, norm_obs)
                        if logstd is None:
                            logstd = fixed_logstd
                        a_rand = mean + torch.exp(logstd) * noise[t]
                        norm_a = torch.where(bern[t] == 1.0, a_rand, mean)
                        a_logp = dist.log_prob(mean, logstd, norm_a)
                        action = norm_a * self.a_std + self.a_mean

                        count = count + float(N)
                        s1 = s1 + obs.sum(0)
                        s2 = s2 + (obs * obs).sum(0)

                    with span("env.step"):
                        env_state, obs_after, aux, step_out = env.rollout_step_cached(
                            env_state, action, aux, ids_f[t], times_f[t],
                            {k: v[t] for k, v in dr_f.items()})
                    with span("rollout.record"):
                        next_obs = step_out.pop("next_obs")
                        if cfg.disc_mode != "amp":
                            step_out["disc_diff"] = (step_out.pop("disc_obs_demo")
                                                     - step_out.pop("disc_obs"))
                        steps.append(dict(
                            norm_obs=norm_obs.to(out_dtype),
                            norm_next=norm.normalize(ts.obs_norm, next_obs).to(out_dtype),
                            norm_a=norm_a, a_logp=a_logp, rand_mask=bern[t][:, 0],
                            **step_out,
                        ))
                    obs = obs_after
        with span("rollout.stack"):
            traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return env_state, obs, traj, (count, s1, s2)

    def _rollout_steps(self, ts: TrainState, env_state: EnvState, obs, num_steps: int,
                       train: bool, generator, draws):
        """The steps of the rich rollout, one at a time: yields
        ``(env_state, obs_after, step)`` with ``step`` the step's record
        (its obs, action, log-prob, exploration mask and the outputs of
        ``env.rollout_step``)."""
        env = self.env
        exp_prob = self._exp_prob(ts.sample_count) if train else None
        for t in range(num_steps):
            noise = bern = step_draws = None
            if draws is not None:
                noise, bern, ids, times = draws[:4]
                if train:
                    noise = to_device(noise[t], self.device, torch.float32)
                    bern = to_device(bern[t], self.device, torch.float32)
                step_draws = (ids[t], times[t])
                if len(draws) > 4:
                    step_draws += ({k: v[t] for k, v in draws[4].items()},)
            action, _, a_logp, rand_mask = self._decide_action(
                ts.params, ts.obs_norm, obs, train, exp_prob, noise, bern, generator)
            env_state, obs_after, out = env.rollout_step(
                env_state, action, ts.sampler, generator, draws=step_draws)
            yield env_state, obs_after, dict(obs=obs, action=action, a_logp=a_logp,
                                             rand_mask=rand_mask, **out)
            obs = obs_after

    @torch.no_grad()
    def rollout(self, ts: TrainState, env_state: EnvState, obs, num_steps: int,
                train: bool = True, generator: torch.Generator | None = None, draws=None):
        """The rich rollout: ``num_steps`` of action, ``env.rollout_step``
        (step, masked reset, obs), recording raw obs, actions and the
        step's outputs.  ``train=False`` acts with the actor's mean (the
        evaluation policy).  ``draws = (noise, bern, ids, times[, dr])``,
        each [T, ...] (``dr`` a dict of [T, N]; ``noise`` and ``bern``
        unread without ``train``), replaces the random draws.  Returns
        ``(env_state, obs, traj)`` with traj tensors [T, N, ...].
        """
        steps = []
        for env_state, obs, step in self._rollout_steps(ts, env_state, obs, num_steps, train,
                                                         generator, draws):
            steps.append(step)
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return env_state, obs, traj

    def eval_rollout(self, ts: TrainState, env_state: EnvState, obs, num_steps: int,
                     generator: torch.Generator | None = None, draws=None):
        """Deterministic (mean action) rollout for evaluation: returns
        ``(env_state, obs, reward [T, N], done [T, N])``; episode
        statistics are taken on the host (``learning.runner.episode_stats``)."""
        env_state, obs, traj = self.rollout(ts, env_state, obs, num_steps, train=False,
                                            generator=generator, draws=draws)
        return env_state, obs, traj["reward"], traj["done"]

    @torch.no_grad()
    def eval_rollout_states(self, ts: TrainState, env_state: EnvState, obs, num_steps: int,
                            generator: torch.Generator | None = None, draws=None):
        """Deterministic (mean action) rollout recording env 0's trajectory,
        for the videos (``learning.runner.Trainer.record_video``).

        Each step is the evaluation rollout's (:meth:`rollout` with
        ``train=False``: one control step through the env's backend, the
        masked reset and the obs); the state is taken after the reset, so
        a reset of env 0 shows as a jump.  ``draws`` as in :meth:`rollout`.
        Returns ``(env_state, obs, states)`` with ``states`` a dict of
        [T, ...] tensors: ``root_pos``, ``root_quat``, ``dof_pos``, and the
        reference motion's ``motion_id`` and ``motion_time`` (for the
        ghost).
        """
        rec = []
        for env_state, obs, _ in self._rollout_steps(ts, env_state, obs, num_steps, False,
                                                      generator, draws):
            sim = env_state.sim
            rec.append(dict(root_pos=sim.root_pos[0], root_quat=sim.root_quat[0],
                            dof_pos=sim.dof_pos[0], motion_id=env_state.motion_ids[0],
                            motion_time=self.env.motion_times(env_state)[0]))
        states = {k: torch.stack([r[k] for r in rec]) for k in rec[0]}
        return env_state, obs, states

    # ---------------------------------------------------------- train data

    def _disc_reward_from_input(self, net: ADDNet, disc_in):
        """-log(1 - sigmoid(logit)), floored at 1e-4, times the reward scale."""
        prob = torch.sigmoid(self._disc(net, disc_in))
        r = -torch.log(torch.clamp_min(1.0 - prob, 1e-4))
        return r * self.cfg.disc_reward_scale

    @torch.no_grad()
    def build_train_data(self, ts: TrainState, traj, demo_draws=None,
                         generator: torch.Generator | None = None):
        """Rewards, TD(lambda) returns, normalized advantages and the
        sampler update from a ``rollout_lean`` trajectory.

        ``add``: the disc input is the normalized aligned difference.
        ``amp``: fresh demo windows for all T x N samples
        (``env.fetch_disc_obs_demo``; ``demo_draws = (ids, times)`` of T x N
        replaces its draws from ``generator``), the disc input the
        normalized agent obs and the positive the normalized demo obs.
        ``none``: no disc reward.  The sampler's error is always taken
        against the aligned demo, before any AMP replacement.

        Returns ``(ts, data, info)``: ``ts`` with the new sampler errors,
        ``data`` the trajectory plus ``reward`` (the task and disc reward
        mix), ``tar_val``, ``adv``, and [T, N, ...] ``disc_in`` (not under
        ``none``) and, under ``amp``, ``disc_pos`` and the fresh
        ``disc_obs_demo``.
        """
        cfg = self.cfg
        net = ts.params
        aligned_diff = (traj["disc_diff"] if "disc_diff" in traj
                        else traj["disc_obs_demo"] - traj["disc_obs"])
        task_r = traj["reward"]
        T, N = task_r.shape
        disc = {}
        if cfg.disc_mode == "amp":
            g = generator if generator is not None else self.generator
            demo = self.env.fetch_disc_obs_demo(T * N, ts.sampler, g, draws=demo_draws)
            demo = demo.reshape((T, N) + tuple(demo.shape[1:]))
            disc = dict(disc_obs_demo=demo, disc_in=norm.normalize(ts.disc_norm, traj["disc_obs"]),
                        disc_pos=norm.normalize(ts.disc_norm, demo))
        elif cfg.disc_mode == "add":
            disc = dict(disc_in=norm.diff_normalize(ts.disc_norm, aligned_diff))
        if cfg.disc_mode == "none":
            disc_r = torch.zeros_like(task_r)
            r = cfg.task_reward_weight * task_r
        else:
            disc_r = self._disc_reward_from_input(net, disc["disc_in"])
            r = cfg.task_reward_weight * task_r + cfg.disc_reward_weight * disc_r

        # the adaptive sampler's error: tracking error against the aligned
        # demo, per-segment sums over all ranks' envs
        diff_sq = torch.sum(aligned_diff * aligned_diff, dim=-1)
        total, count = self._global_sum(*sampler_mod.segment_stats(
            ts.sampler, self.env.seg_sizes,
            traj["motion_ids"].reshape(-1), traj["motion_times"].reshape(-1),
            diff_sq.reshape(-1),
        ))
        new_sampler = sampler_mod.update_errors_from_stats(ts.sampler, total, count)

        vals = self._critic(net, traj["norm_obs"])
        next_vals = self._critic(net, traj["norm_next"])
        done = traj["done"]
        terminal = (done == int(DoneFlags.SUCC)) | (done == int(DoneFlags.FAIL))
        next_vals = torch.where(terminal, 0.0, next_vals)

        ret = td_lambda_return(r, next_vals, done, cfg.discount, cfg.td_lambda)
        adv = ret - vals

        # masked advantage moments over all ranks' samples, in two passes
        # (a global mean, then the global sum of squared deviations)
        mask = traj["rand_mask"] == 1.0
        n = float(adv.numel() * self.dist.world_size)
        adv_sum, cnt, disc_r_sum, task_r_sum = self._global_sum(
            torch.sum(adv * mask), mask.sum().float(), disc_r.sum(), task_r.sum())
        cnt = torch.clamp_min(cnt, 1.0)
        adv_mean = adv_sum / cnt
        disc_r_mean = disc_r_sum / n
        adv_sq, disc_r_sq = self._global_sum(
            torch.sum((adv - adv_mean) ** 2 * mask), torch.sum((disc_r - disc_r_mean) ** 2))
        adv_std = torch.sqrt(adv_sq / torch.clamp_min(cnt - 1, 1.0))
        norm_adv = (adv - adv_mean) / torch.clamp_min(adv_std, 1e-5)
        norm_adv = torch.clamp(norm_adv, -cfg.norm_adv_clip, cfg.norm_adv_clip)

        data = dict(traj, reward=r, tar_val=ret, adv=norm_adv, **disc)
        info = dict(
            adv_mean=adv_mean, adv_std=adv_std,
            disc_reward_mean=disc_r_mean, disc_reward_std=torch.sqrt(disc_r_sq / n),
            task_reward_mean=task_r_sum / n,
        )
        return replace(ts, sampler=new_sampler), data, info

    # -------------------------------------------------------------- losses

    def _loss(self, net: ADDNet, batch):
        """PPO actor loss + critic loss (+ disc loss but under ``none``) on
        one minibatch.  Returns ``(loss, info)``; ``info`` holds detached
        scalars."""
        cfg = self.cfg
        norm_obs = batch["norm_obs"]

        pred = self._critic(net, norm_obs)
        critic_loss = torch.mean((batch["tar_val"] - pred) ** 2)

        # actor on rand-masked samples only
        mean, logstd = self._actor(net, norm_obs)
        logstd = self._logstd(mean, logstd)
        a_logp = dist.log_prob(mean, logstd, batch["norm_a"])
        mask = (batch["rand_mask"] == 1.0).float()
        cnt = torch.clamp_min(mask.sum(), 1.0)

        ratio = torch.exp(a_logp - batch["a_logp"])
        adv = batch["adv"]
        l0 = adv * ratio
        l1 = adv * torch.clamp(ratio, 1.0 - cfg.ppo_clip_ratio, 1.0 + cfg.ppo_clip_ratio)
        actor_loss = -torch.sum(torch.minimum(l0, l1) * mask) / cnt
        clip_frac = torch.sum(((ratio - 1.0).abs() > cfg.ppo_clip_ratio) * mask) / cnt
        imp_ratio = torch.sum(ratio * mask) / cnt

        # action bound loss on the mode in [-1, 1]
        if cfg.action_bound_weight != 0:
            viol = (torch.sum(torch.clamp_max(mean + 1.0, 0.0) ** 2, -1)
                    + torch.sum(torch.clamp_min(mean - 1.0, 0.0) ** 2, -1))
            bound_loss = torch.sum(viol * mask) / cnt
            actor_loss = actor_loss + cfg.action_bound_weight * bound_loss
        else:
            bound_loss = torch.zeros((), device=mean.device)
        if cfg.action_entropy_weight != 0:
            actor_loss = actor_loss - cfg.action_entropy_weight * torch.mean(dist.entropy(mean, logstd))
        if cfg.action_reg_weight != 0:
            actor_loss = actor_loss + cfg.action_reg_weight * torch.mean(dist.param_reg(mean))

        loss = actor_loss + cfg.critic_loss_weight * critic_loss
        info = dict(actor_loss=actor_loss, critic_loss=critic_loss, clip_frac=clip_frac,
                    imp_ratio=imp_ratio, action_bound_loss=bound_loss)
        if cfg.disc_mode != "none":
            disc_loss, disc_info = self._disc_loss(net, batch)
            loss = loss + cfg.disc_loss_weight * disc_loss
            info.update(disc_info)
        info["loss"] = loss
        return loss, {k: v.detach() for k, v in info.items()}

    def _disc_loss(self, net: ADDNet, batch):
        """Disc loss: BCE with 0.9/0.1 labels on a positive and a negative
        input, a gradient penalty that is differentiated again
        (``create_graph``), logit-weight regularization and weight decay on
        the trunk and logit kernels.  ``add``: the positive is the zero
        difference, the negative the normalized demo-agent difference, the
        penalty ``(|d logit / d input| - 1)^2`` on the negative input.
        ``amp``: the positive is the normalized demo obs, the negative the
        agent's, the penalty ``|d logit / d input|^2`` on the positive."""
        cfg = self.cfg
        amp = cfg.disc_mode == "amp"
        grad_side = batch["disc_pos"] if amp else batch["disc_in"]
        grad_in_x = grad_side.detach().requires_grad_(True)
        grad_logit = self._disc(net, grad_in_x)
        grad_in, = torch.autograd.grad(grad_logit.sum(), grad_in_x, create_graph=True)
        grad_in = grad_in.float()
        if amp:
            pos_logit, neg_logit = grad_logit, self._disc(net, batch["disc_in"])
        else:
            neg_logit = grad_logit
            pos_logit = self._disc(net, torch.zeros((1, grad_in_x.shape[-1]), device=grad_in_x.device))

        def bce(logit, label):
            return -label * F.logsigmoid(logit) - (1.0 - label) * F.logsigmoid(-logit)

        disc_loss = 0.5 * (bce(pos_logit, 0.9).mean() + bce(neg_logit, 0.1).mean())
        logit_w = net.disc_logit.weight
        disc_loss = disc_loss + cfg.disc_logit_reg * torch.sum(logit_w * logit_w)
        if amp:
            grad_penalty = torch.mean(torch.sum(grad_in * grad_in, dim=-1))
        else:
            grad_norm = torch.sqrt(torch.sum(grad_in * grad_in, dim=-1) + 1e-8)
            grad_penalty = torch.mean((grad_norm - 1.0) ** 2)
        disc_loss = disc_loss + cfg.disc_grad_penalty * grad_penalty
        if cfg.disc_weight_decay != 0:
            wd = sum(torch.sum(w * w) for name, w in net.disc_trunk.named_parameters()
                     if name.endswith("weight"))
            disc_loss = disc_loss + cfg.disc_weight_decay * (wd + torch.sum(logit_w * logit_w))
        info = dict(
            disc_loss=disc_loss, disc_grad_penalty=grad_penalty,
            disc_pos_logit=pos_logit.mean(), disc_neg_logit=neg_logit.mean(),
            disc_pos_acc=(pos_logit > 0).float().mean(),
            disc_neg_acc=(neg_logit < 0).float().mean(),
        )
        return disc_loss, info

    # --------------------------------------------------------------- update

    def _opt_step(self, net: ADDNet, grads, opt_state):
        cfg = self.cfg
        if cfg.optimizer == "sgd":
            return optim.clip_sgd_step(list(net.parameters()), grads, opt_state,
                                       cfg.learning_rate, cfg.grad_clip, cfg.momentum)
        # optimizer "adam" and "fused_adam" are one step (optim module docstring)
        return optim.clip_adam_step(
            list(net.parameters()), grads, opt_state, cfg.learning_rate, cfg.grad_clip)

    def _mean_grads(self, grads):
        """The gradients averaged over the ranks (the DDP contract): one
        collective over a flat buffer, divided by the world size on every
        rank alike, before the clip sees them."""
        if self.dist.world_size == 1:
            return grads
        flat = self.dist.all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]))
        return [x.view_as(g) for x, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)]

    def _epoch_scan(self, net: ADDNet, opt_state, flat, num_batches: int, env_count: int,
                    perms=None, generator: torch.Generator | None = None):
        """Epochs of minibatch steps over a flat, time-major [M, ...] buffer
        (row t * N + n).  Each epoch permutes blocks of ``B`` rows
        (:func:`pick_shuffle_block`) and cuts the permutation into
        ``num_batches`` minibatches; ``perms`` [epochs][M // B] replaces
        the permutations (the JAX package draws them with
        ``jax.random.permutation``); under data parallelism each rank
        permutes its own rows from its own stream and the gradients are
        averaged over the ranks per minibatch.  Returns ``(opt_state,
        infos)`` with each info stacked over the epochs x minibatches."""
        cfg = self.cfg
        g = generator if generator is not None else self.generator
        M = flat["a_logp"].shape[0]
        mb_size = M // num_batches
        B = pick_shuffle_block(M, num_batches, mb_size, env_count, cfg.minibatch_blocks)
        nblk, mb_blk = M // B, mb_size // B
        blocks = {k: v.reshape((nblk, B) + v.shape[1:]) for k, v in flat.items()}
        params = list(net.parameters())
        infos = []
        for e in range(cfg.update_epochs):
            if perms is None:
                perm = torch.randperm(nblk, generator=g, device=self.device)
            else:
                perm = to_device(perms[e], self.device, torch.int64)
            idx = perm[: num_batches * mb_blk].reshape(num_batches, mb_blk)
            for b in range(num_batches):
                with span("update.minibatch"):
                    with span("update.batch"):
                        batch = {k: v[idx[b]].reshape((mb_size,) + v.shape[2:])
                                 for k, v in blocks.items()}
                    with span("update.loss"):
                        loss, info = self._loss(net, batch)
                    with span("update.grad"):
                        grads = torch.autograd.grad(loss, params)
                    with span("update.allreduce"):
                        grads = self._mean_grads(grads)
                    with span("update.opt"):
                        opt_state = self._opt_step(net, grads, opt_state)
                    infos.append(info)
        return opt_state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}

    def update_model(self, ts: TrainState, data, perms=None,
                     generator: torch.Generator | None = None):
        """Epoch/minibatch PPO (+ disc) updates on this rank's data; the
        parameters are updated in place.  Returns ``(ts, info)`` with each
        info the mean over all minibatch steps (and over the ranks, once
        after the last step)."""
        cfg = self.cfg
        T, N = data["reward"].shape
        cols = {k: data[k] for k in MODE_FIELDS[cfg.disc_mode]}
        if cfg.mixed_precision:
            cols["norm_obs"] = cols["norm_obs"].to(torch.bfloat16)
        if cfg.disc_mixed_precision:
            for k in ("disc_in", "disc_pos"):
                if k in cols:
                    cols[k] = cols[k].to(torch.bfloat16)
        flat = {k: v.reshape((T * N,) + v.shape[2:]) for k, v in cols.items()}
        num_batches = int(np.ceil(T / cfg.batch_size))
        opt_state, infos = self._epoch_scan(
            ts.params, ts.opt_state, flat, num_batches, N, perms, generator)
        info = {k: v.mean() for k, v in infos.items()}
        info = dict(zip(info, self.dist.all_reduce_mean(torch.stack(list(info.values())))))
        return replace(ts, opt_state=opt_state), info

    # ------------------------------------------------------------ train iter

    def train_iter(self, ts: TrainState, env_state: EnvState, obs,
                   generator: torch.Generator | None = None, draws=None, perms=None,
                   hook=None, demo_draws=None):
        """One training iteration: rollout, train data, model update, then
        the normalizer updates (while ``sample_count`` is below
        ``normalizer_samples``); ``sample_count`` grows by the steps of all
        ranks' envs.  ``draws`` (see :meth:`rollout_lean`), ``demo_draws``
        (see :meth:`build_train_data`) and ``perms`` (see
        :meth:`_epoch_scan`) replace the random draws.  ``hook``, if given,
        is called as ``hook(phase, outputs)`` once each phase has been
        issued: "rollout" with the trajectory and the next ``obs``, "data"
        with the train data, "update" with the update's infos
        (``chip_smoke.py`` records a CUDA event there; ``debug.nans``
        checks the outputs).  Returns ``(ts, env_state, obs, info)``;
        ``info`` holds device scalars.

        While a profiler runs, the iteration records its spans
        (``utils.trace``): the root ``train_iter`` holds ``rollout`` (one
        ``rollout.step`` a control step: ``policy``, ``env.step``,
        ``rollout.record``), ``data``, ``update`` (one ``update.minibatch`` a
        minibatch step) and ``normalizers``."""
        cfg = self.cfg
        with span("train_iter"):
            with span("rollout"):
                env_state, obs, traj, obs_stats = self.rollout_lean(
                    ts, env_state, obs, cfg.steps_per_iter, generator, draws=draws)
            if hook is not None:
                hook("rollout", dict(traj, obs=obs))
            with span("data"):
                ts, data, data_info = self.build_train_data(ts, traj, demo_draws, generator)
            if hook is not None:
                hook("data", data)
            with span("update"):
                ts, train_info = self.update_model(ts, data, perms, generator)
            if hook is not None:
                hook("update", train_info)

            with span("normalizers"), torch.no_grad():
                update = ts.sample_count < cfg.normalizer_samples
                new_obs = norm.update_normalizer_from_stats(ts.obs_norm,
                                                            *self._global_sum(*obs_stats))
                new_disc, disc_fields = self._disc_norm_update(ts.disc_norm, data)
                pick = lambda new, old, names: replace(new, **{
                    f: torch.where(update, getattr(new, f), getattr(old, f)) for f in names})
                T, N = data["reward"].shape
                ts = replace(
                    ts,
                    obs_norm=pick(new_obs, ts.obs_norm, ("count", "mean", "mean_sq")),
                    disc_norm=pick(new_disc, ts.disc_norm, disc_fields),
                    sample_count=ts.sample_count + cfg.steps_per_iter * N * self.dist.world_size,
                )

                # means over all ranks' samples, from global sums and counts
                done = traj["done"]
                done_mask = (done != 0).float()
                n = float(done.numel() * self.dist.world_size)
                r_sum, len_sum, n_done, n_fail = self._global_sum(
                    data["reward"].sum(),
                    torch.sum(traj["ep_time"] / self.env.ctrl_dt * done_mask),
                    done_mask.sum(), (done == int(DoneFlags.FAIL)).float().sum())
                info = dict(data_info, **train_info)
                info["mean_reward"] = r_sum / n
                # at each done, ep_time is the finished episode's length
                info["mean_ep_len"] = len_sum / torch.clamp_min(n_done, 1.0)
                info["done_frac"] = n_done / n
                info["fail_frac"] = n_fail / n
        return ts, env_state, obs, info

    def _disc_norm_update(self, disc_norm, data):
        """The disc normalizer merged with this iteration's samples of all
        ranks, and the names of its fields.  ``amp``: a running mean/std of
        the agent's and the fresh demo's disc obs, from global sums;
        ``add`` and ``none``: the mean |x| of the aligned differences."""
        if self.cfg.disc_mode == "amp":
            both = [data[k].reshape((-1,) + tuple(disc_norm.mean.shape)).float()
                    for k in ("disc_obs", "disc_obs_demo")]
            n, s, s_sq = self._global_sum(float(sum(x.shape[0] for x in both)),
                                          sum(x.sum(0) for x in both),
                                          sum((x * x).sum(0) for x in both))
            return norm.update_normalizer_from_stats(disc_norm, n, s, s_sq), ("count", "mean", "mean_sq")
        diff = data["disc_diff"].reshape((-1,) + tuple(disc_norm.mean_abs.shape)).float()
        n_all = diff.shape[0] * self.dist.world_size
        # each rank's mean |x| weighted by its share of the samples and
        # summed: the mean over all ranks (the rank's own mean at one rank)
        mean_abs = self._global_sum(diff.abs().mean(0) * (diff.shape[0] / n_all))
        return (norm.update_diff_normalizer_from_stats(disc_norm, float(n_all), mean_abs),
                ("count", "mean_abs"))


def pick_shuffle_block(M: int, num_batches: int, mb_size: int, env_count: int,
                       mode: str = "auto") -> int:
    """Rows per minibatch-shuffle block.

    "auto": the largest of 32 and 8 that tiles the minibatches and divides
    ``env_count``, so that a block is adjacent envs at one timestep
    (independent samples), else 1.  "timestep": a block is one whole
    timestep (``env_count`` rows) where timesteps tile the minibatches,
    else as "auto".  Any other mode raises.
    """
    if mode not in ("auto", "timestep"):
        raise ValueError(f"minibatch_blocks must be auto or timestep, got {mode!r}")
    if mode == "timestep" and M % num_batches == 0 and mb_size % env_count == 0:
        return env_count
    if M % num_batches == 0:
        for cand in (32, 8):
            if mb_size % cand == 0 and env_count % cand == 0:
                return cand
    return 1


def td_lambda_return(r, next_vals, done, discount: float, td_lambda: float):
    """TD(lambda) return [T, N] by a reverse loop; a reset (done != NULL)
    cuts the lambda trace."""
    reset = (done != int(DoneFlags.NULL)).to(r.dtype)
    T = r.shape[0]
    rets = [None] * T
    rets[-1] = r[-1] + discount * next_vals[-1]
    for t in range(T - 2, -1, -1):
        lam = td_lambda * (1.0 - reset[t])
        rets[t] = r[t] + discount * ((1.0 - lam) * next_vals[t] + lam * rets[t + 1])
    return torch.stack(rets)
