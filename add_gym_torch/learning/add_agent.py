"""ADD agent: configuration, train state and the acting path.

Counterpart of ``add_gym_tpu/learning/add_agent.py`` for the rollout:
``AgentConfig``, a ``TrainState`` (no optimizer state yet), network and
normalizer init, the mixed-precision actor and ``rollout_lean``, the train
rollout that ``train_iter`` times.  ``build_train_data``, the losses and
``update_model`` are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from add_gym_torch.envs.domain_rand import init_dr_state
from add_gym_torch.envs.imitation import EnvState, ImitationEnv, to_device
from add_gym_torch.learning import distributions as dist
from add_gym_torch.learning import normalizer as norm
from add_gym_torch.learning import sampler as sampler_mod
from add_gym_torch.learning.networks import ADDNet


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
    obs_norm: norm.NormState
    disc_norm: norm.DiffNormState
    sampler: sampler_mod.SamplerState
    sample_count: torch.Tensor  # [] int


class ADDAgent:
    """Binds env + networks + config into the acting functions."""

    def __init__(self, env: ImitationEnv, cfg: AgentConfig,
                 generator: torch.Generator | None = None):
        if cfg.disc_mode != "add":
            raise NotImplementedError(f"disc_mode {cfg.disc_mode!r} is not ported yet")
        if cfg.actor_std_type != "fixed":
            raise NotImplementedError(f"actor_std_type {cfg.actor_std_type!r} is not ported yet")
        self.env = env
        self.cfg = cfg
        self.device = env.device
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

    # --------------------------------------------------------------- acting

    def _exp_prob(self, sample_count) -> float:
        cfg = self.cfg
        if not math.isfinite(cfg.exp_anneal_samples):
            return cfg.exp_prob
        l = min(max(float(sample_count) / cfg.exp_anneal_samples, 0.0), 1.0)
        return (1.0 - l) * cfg.exp_prob + l * cfg.exp_prob_end

    def sample_rollout_draws(self, ts: TrainState, num_envs: int, num_steps: int,
                             generator: torch.Generator | None = None):
        """Presampled rollout randomness: (noise [T,N,nd], bern [T,N,1],
        reset ids [T,N], reset times [T,N])."""
        g = generator if generator is not None else self.generator
        env, dev = self.env, self.device
        T, N = num_steps, num_envs
        noise = torch.randn((T, N, env.num_dofs), generator=g, device=dev)
        p = torch.full((T, N, 1), self._exp_prob(ts.sample_count), device=dev)
        bern = torch.bernoulli(p, generator=g)
        ids, times = env.sample_resets(T * N, ts.sampler, g)
        return noise, bern, ids.reshape(T, N), times.reshape(T, N)

    @torch.no_grad()
    def rollout_lean(self, ts: TrainState, env_state: EnvState, obs, num_steps: int,
                     generator: torch.Generator | None = None, draws=None):
        """Train rollout: ``num_steps`` control steps with masked resets.

        Records normalized obs (bf16 under mixed precision), the normalized
        action, its log-prob and the ADD disc difference, and accumulates
        the obs-normalizer statistics over the acting obs.  ``draws`` =
        (noise, bern, ids, times) replaces the presampled randomness (the
        parity tests inject the JAX package's draws).

        Returns ``(env_state, obs, traj, obs_stats)``: traj tensors are
        [T, N, ...]; obs_stats = (count, sum[obs_dim], sum_sq[obs_dim]).
        """
        env, cfg, dev = self.env, self.cfg, self.device
        N = obs.shape[0]
        if draws is None:
            draws = self.sample_rollout_draws(ts, N, num_steps, generator)
        noise, bern, ids_f, times_f = draws
        noise, bern, times_f = (to_device(x, dev, torch.float32) for x in (noise, bern, times_f))
        ids_f = to_device(ids_f, dev, torch.int64)
        out_dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        net = ts.params
        dr = init_dr_state(N, dev)

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
                env_state, action, aux, ids_f[t], times_f[t], dr
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
