"""ADD agent: PPO + adversarial differential discriminator.

Counterpart of ``add_gym_tpu/learning/add_agent.py`` for ``disc_mode:
add``: ``AgentConfig``, ``TrainState`` (with the optimizer's moments),
network and normalizer init, the evaluation rollout (``rollout``,
``eval_rollout``) and one training iteration, ``train_iter``:

1. ``rollout_lean``: the train rollout (bf16 actor under mixed precision,
   presampled action noise, reset and domain-randomization draws);
2. ``build_train_data``: the ADD disc reward on normalized obs
   differences, critic values, TD(lambda) returns, masked advantage
   normalization and the sampler's error update;
3. ``update_model``: epochs of shuffled minibatches of the PPO actor loss,
   the critic loss and the disc loss with its gradient penalty (a double
   backward), each followed by a clipped Adam step (``learning/optim.py``);
4. the obs and disc normalizer updates, gated by ``normalizer_samples``.

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
from add_gym_torch.learning.networks import ADDNet
from add_gym_torch.parallel.mesh import Dist

# the minibatch fields the losses read (update_model gathers only these)
UPDATE_FIELDS = ("norm_obs", "norm_a", "a_logp", "tar_val", "adv", "rand_mask", "disc_in")


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
    opt_state: optim.AdamState
    obs_norm: norm.NormState
    disc_norm: norm.DiffNormState
    sampler: sampler_mod.SamplerState
    sample_count: torch.Tensor  # [] int


def train_state_dict(ts: TrainState) -> dict:
    """The train state as a dict of tensors (what a checkpoint holds)."""
    return dict(
        params=ts.params.state_dict(),
        opt_count=ts.opt_state.count, opt_mu=list(ts.opt_state.mu), opt_nu=list(ts.opt_state.nu),
        obs_norm=dict(count=ts.obs_norm.count, mean=ts.obs_norm.mean, mean_sq=ts.obs_norm.mean_sq),
        disc_norm=dict(count=ts.disc_norm.count, mean_abs=ts.disc_norm.mean_abs),
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
    """SHA-256 of every tensor of the train state (network, Adam moments,
    normalizers, sampler, sample count): equal digests mean equal bits."""
    h = hashlib.sha256()
    for t in state_tensors(train_state_dict(ts)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def load_train_state_dict(ts: TrainState, d: dict) -> TrainState:
    """``ts`` holding the values of ``d`` (a :func:`train_state_dict`) on
    ``ts``'s device; the network is loaded in place.  Raises on a shape
    that does not fit."""
    dev = ts.sample_count.device
    t = lambda x, like: torch.as_tensor(x).to(device=dev, dtype=like.dtype)
    ts.params.load_state_dict(d["params"])
    params = list(ts.params.parameters())
    if len(d["opt_mu"]) != len(params):
        raise ValueError(f"checkpoint has {len(d['opt_mu'])} moments, the network "
                         f"{len(params)} parameters")
    return replace(
        ts,
        opt_state=optim.AdamState(
            count=t(d["opt_count"], ts.opt_state.count),
            mu=[t(m, p).reshape(p.shape) for m, p in zip(d["opt_mu"], params)],
            nu=[t(v, p).reshape(p.shape) for v, p in zip(d["opt_nu"], params)],
        ),
        obs_norm=replace(ts.obs_norm, **{k: t(v, ts.obs_norm.mean) for k, v in d["obs_norm"].items()}),
        disc_norm=replace(ts.disc_norm, **{k: t(v, ts.disc_norm.mean_abs)
                                           for k, v in d["disc_norm"].items()}),
        sampler=sampler_mod.SamplerState(errors=t(d["sampler_errors"], ts.sampler.errors)),
        sample_count=t(d["sample_count"], ts.sample_count),
    )


class ADDAgent:
    """Binds env + networks + config into the acting functions."""

    def __init__(self, env: ImitationEnv, cfg: AgentConfig,
                 generator: torch.Generator | None = None, dist: Dist | None = None):
        if cfg.disc_mode != "add":
            raise NotImplementedError(f"disc_mode {cfg.disc_mode!r} is not ported yet")
        if cfg.actor_std_type != "fixed":
            raise NotImplementedError(f"actor_std_type {cfg.actor_std_type!r} is not ported yet")
        if cfg.optimizer not in ("adam", "fused_adam"):
            raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported yet")
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

    # ------------------------------------------------------------------ init

    def init_train_state(self, generator: torch.Generator | None = None) -> TrainState:
        g = generator if generator is not None else self.generator
        cfg, env = self.cfg, self.env
        obs_dim, disc_dim = env.obs_dim(), env.disc_obs_dim()
        net = ADDNet(
            obs_dim, disc_dim, env.num_dofs,
            actor_net=cfg.actor_net, critic_net=cfg.critic_net, disc_net=cfg.disc_net,
            actor_init_output_scale=cfg.actor_init_output_scale, generator=g,
            device=self.device,
        )
        return TrainState(
            params=net,
            opt_state=optim.init_adam(net.parameters()),
            obs_norm=norm.init_normalizer((obs_dim,), device=self.device),
            disc_norm=norm.init_diff_normalizer((disc_dim,), device=self.device),
            sampler=sampler_mod.init_sampler(
                env.motion.num_motions, env.task.sampler_num_segments, self.device),
            sample_count=torch.zeros((), dtype=torch.int64, device=self.device),
        )

    # ------------------------------------------------------- mixed precision

    def _trunk_dtype(self):
        return torch.bfloat16 if self.cfg.mixed_precision else None

    def _actor_mean(self, net: ADDNet, norm_obs):
        """Actor mean at the configured precision (bf16 trunk, f32 head)."""
        return net.actor(norm_obs, self._trunk_dtype())

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
        mean = self._actor_mean(net, norm_obs)
        logstd = torch.full_like(mean, self.logstd)
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
        action, its log-prob and the ADD disc difference, and accumulates
        the obs-normalizer statistics over the acting obs.  ``draws`` =
        (noise, bern, ids, times[, dr_f]) replaces the presampled randomness
        (the parity tests inject the JAX package's draws); ``dr_f``, the
        reset perturbations of domain randomization, is a dict of [T, N].

        Returns ``(env_state, obs, traj, obs_stats)``: traj tensors are
        [T, N, ...]; obs_stats = (count, sum[obs_dim], sum_sq[obs_dim]).
        """
        env, cfg, dev = self.env, self.cfg, self.device
        N = obs.shape[0]
        if draws is None:
            draws = self.sample_rollout_draws(ts, N, num_steps, generator)
        noise, bern, ids_f, times_f = draws[:4]
        noise, bern, times_f = (to_device(x, dev, torch.float32) for x in (noise, bern, times_f))
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
        logstd = torch.full((N, env.num_dofs), self.logstd, device=dev)
        steps = []
        for t in range(num_steps):
            norm_obs = norm.normalize(ts.obs_norm, obs)
            mean = self._actor_mean(net, norm_obs)
            a_rand = mean + torch.exp(logstd) * noise[t]
            norm_a = torch.where(bern[t] == 1.0, a_rand, mean)
            a_logp = dist.log_prob(mean, logstd, norm_a)
            action = norm_a * self.a_std + self.a_mean

            count = count + float(N)
            s1 = s1 + obs.sum(0)
            s2 = s2 + (obs * obs).sum(0)

            env_state, obs_after, aux, step_out = env.rollout_step_cached(
                env_state, action, aux, ids_f[t], times_f[t], {k: v[t] for k, v in dr_f.items()}
            )
            next_obs = step_out.pop("next_obs")
            step_out["disc_diff"] = step_out.pop("disc_obs_demo") - step_out.pop("disc_obs")
            steps.append(dict(
                norm_obs=norm_obs.to(out_dtype),
                norm_next=norm.normalize(ts.obs_norm, next_obs).to(out_dtype),
                norm_a=norm_a, a_logp=a_logp, rand_mask=bern[t][:, 0],
                **step_out,
            ))
            obs = obs_after
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return env_state, obs, traj, (count, s1, s2)

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
        env = self.env
        exp_prob = self._exp_prob(ts.sample_count) if train else None
        steps = []
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
            steps.append(dict(obs=obs, action=action, a_logp=a_logp, rand_mask=rand_mask, **out))
            obs = obs_after
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

    # ---------------------------------------------------------- train data

    def _disc_reward_from_input(self, net: ADDNet, disc_in):
        """-log(1 - sigmoid(logit)), floored at 1e-4, times the reward scale."""
        prob = torch.sigmoid(self._disc(net, disc_in))
        r = -torch.log(torch.clamp_min(1.0 - prob, 1e-4))
        return r * self.cfg.disc_reward_scale

    @torch.no_grad()
    def build_train_data(self, ts: TrainState, traj):
        """Rewards, TD(lambda) returns, normalized advantages and the
        sampler update from a ``rollout_lean`` trajectory.

        Returns ``(ts, data, info)``: ``ts`` with the new sampler errors,
        ``data`` the trajectory plus ``reward`` (the disc reward mix),
        ``tar_val``, ``adv`` and ``disc_in`` [T, N, ...].
        """
        cfg = self.cfg
        net = ts.params
        aligned_diff = traj["disc_diff"]
        task_r = traj["reward"]
        disc_in = norm.diff_normalize(ts.disc_norm, aligned_diff)
        disc_r = self._disc_reward_from_input(net, disc_in)
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

        data = dict(traj, reward=r, tar_val=ret, adv=norm_adv, disc_in=disc_in)
        info = dict(
            adv_mean=adv_mean, adv_std=adv_std,
            disc_reward_mean=disc_r_mean, disc_reward_std=torch.sqrt(disc_r_sq / n),
            task_reward_mean=task_r_sum / n,
        )
        return replace(ts, sampler=new_sampler), data, info

    # -------------------------------------------------------------- losses

    def _loss(self, net: ADDNet, batch):
        """PPO actor loss + critic loss + disc loss on one minibatch.
        Returns ``(loss, info)``; ``info`` holds detached scalars."""
        cfg = self.cfg
        norm_obs = batch["norm_obs"]

        pred = self._critic(net, norm_obs)
        critic_loss = torch.mean((batch["tar_val"] - pred) ** 2)

        # actor on rand-masked samples only
        mean = self._actor_mean(net, norm_obs)
        logstd = torch.full_like(mean, self.logstd)
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

        disc_loss, disc_info = self._disc_loss(net, batch)
        loss = actor_loss + cfg.critic_loss_weight * critic_loss + cfg.disc_loss_weight * disc_loss
        info = dict(
            actor_loss=actor_loss, critic_loss=critic_loss, clip_frac=clip_frac,
            imp_ratio=imp_ratio, action_bound_loss=bound_loss, **disc_info, loss=loss,
        )
        return loss, {k: v.detach() for k, v in info.items()}

    def _disc_loss(self, net: ADDNet, batch):
        """ADD disc loss: BCE with 0.9/0.1 labels, the positive is the zero
        difference, the negative the normalized demo-agent difference; the
        gradient penalty ``(|d logit / d input| - 1)^2`` on the negative
        input is differentiated again (``create_graph``); logit-weight
        regularization and weight decay on the trunk and logit kernels."""
        cfg = self.cfg
        neg_in = batch["disc_in"].detach().requires_grad_(True)
        neg_logit = self._disc(net, neg_in)
        grad_in, = torch.autograd.grad(neg_logit.sum(), neg_in, create_graph=True)
        grad_in = grad_in.float()
        pos_logit = self._disc(net, torch.zeros((1, neg_in.shape[-1]), device=neg_in.device))

        def bce(logit, label):
            return -label * F.logsigmoid(logit) - (1.0 - label) * F.logsigmoid(-logit)

        disc_loss = 0.5 * (bce(pos_logit, 0.9).mean() + bce(neg_logit, 0.1).mean())
        logit_w = net.disc_logit.weight
        disc_loss = disc_loss + cfg.disc_logit_reg * torch.sum(logit_w * logit_w)
        grad_norm = torch.sqrt(torch.sum(grad_in * grad_in, dim=-1) + 1e-8)
        grad_penalty = torch.mean((grad_norm - 1.0) ** 2)
        disc_loss = disc_loss + cfg.disc_grad_penalty * grad_penalty
        if cfg.disc_weight_decay != 0:
            wd = sum(torch.sum(lin.weight * lin.weight) for lin in net.disc_trunk.layers)
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
                batch = {k: v[idx[b]].reshape((mb_size,) + v.shape[2:]) for k, v in blocks.items()}
                loss, info = self._loss(net, batch)
                grads = self._mean_grads(torch.autograd.grad(loss, params))
                opt_state = self._opt_step(net, grads, opt_state)
                infos.append(info)
        return opt_state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}

    def update_model(self, ts: TrainState, data, perms=None,
                     generator: torch.Generator | None = None):
        """Epoch/minibatch PPO+ADD updates on this rank's data; the
        parameters are updated in place.  Returns ``(ts, info)`` with each
        info the mean over all minibatch steps (and over the ranks, once
        after the last step)."""
        cfg = self.cfg
        T, N = data["reward"].shape
        cols = {k: data[k] for k in UPDATE_FIELDS}
        if cfg.mixed_precision:
            cols["norm_obs"] = cols["norm_obs"].to(torch.bfloat16)
        if cfg.disc_mixed_precision:
            cols["disc_in"] = cols["disc_in"].to(torch.bfloat16)
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
                   hook=None):
        """One training iteration: rollout, train data, model update, then
        the normalizer updates (while ``sample_count`` is below
        ``normalizer_samples``); ``sample_count`` grows by the steps of all
        ranks' envs.  ``draws`` (see :meth:`rollout_lean`) and
        ``perms`` (see :meth:`_epoch_scan`) replace the random draws.
        ``hook``, if given, is called with "rollout", "data" and "update"
        as each phase has been issued (``chip_smoke.py`` records a CUDA
        event there).  Returns ``(ts, env_state, obs, info)``; ``info``
        holds device scalars."""
        cfg = self.cfg
        hook = hook or (lambda phase: None)
        env_state, obs, traj, obs_stats = self.rollout_lean(
            ts, env_state, obs, cfg.steps_per_iter, generator, draws=draws)
        hook("rollout")
        ts, data, data_info = self.build_train_data(ts, traj)
        hook("data")
        ts, train_info = self.update_model(ts, data, perms, generator)
        hook("update")

        with torch.no_grad():
            update = ts.sample_count < cfg.normalizer_samples
            new_obs = norm.update_normalizer_from_stats(ts.obs_norm, *self._global_sum(*obs_stats))
            diff = traj["disc_diff"].reshape((-1,) + tuple(ts.disc_norm.mean_abs.shape)).float()
            n_all = diff.shape[0] * self.dist.world_size
            # each rank's mean |x| weighted by its share of the samples and
            # summed: the mean over all ranks (the rank's own mean at one rank)
            mean_abs = self._global_sum(diff.abs().mean(0) * (diff.shape[0] / n_all))
            new_disc = norm.update_diff_normalizer_from_stats(ts.disc_norm, float(n_all), mean_abs)
            pick = lambda new, old, names: replace(new, **{
                f: torch.where(update, getattr(new, f), getattr(old, f)) for f in names})
            T, N = data["reward"].shape
            ts = replace(
                ts,
                obs_norm=pick(new_obs, ts.obs_norm, ("count", "mean", "mean_sq")),
                disc_norm=pick(new_disc, ts.disc_norm, ("count", "mean_abs")),
                sample_count=ts.sample_count + cfg.steps_per_iter * N * self.dist.world_size,
            )

            # means over all ranks' samples, from global sums and counts
            done = traj["done"]
            done_mask = (done != 0).float()
            n = float(done.numel() * self.dist.world_size)
            r_sum, len_sum, n_done, n_fail = self._global_sum(
                data["reward"].sum(), torch.sum(traj["ep_time"] / self.env.ctrl_dt * done_mask),
                done_mask.sum(), (done == int(DoneFlags.FAIL)).float().sum())
            info = dict(data_info, **train_info)
            info["mean_reward"] = r_sum / n
            # at each done, ep_time is the finished episode's length
            info["mean_ep_len"] = len_sum / torch.clamp_min(n_done, 1.0)
            info["done_frac"] = n_done / n
            info["fail_frac"] = n_fail / n
        return ts, env_state, obs, info


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
