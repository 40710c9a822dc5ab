"""Assemble env + agent from a composed config dict.

Counterpart of ``add_gym_tpu/builder.py``.  Both entry points take an
explicit ``device`` (default ``"cuda"``); asking for CUDA where there is
none raises instead of running on the CPU.  ``engine.kernel: auto`` keeps
the control-step kernel on a CUDA device with domain randomization on too
(per-env parameters go to the kernel's per-env variant) and with
``engine.general_narrowphase`` (the held narrowphase wrenches go in as
extra input rows).  ``engine.fused: false`` selects the reference-layout
engine instead, which the kernel cannot be (``kernel: on`` then raises).
Under data parallelism (a ``parallel.mesh.Dist`` of several ranks) the
env holds the rank's share of the global ``engine.num_envs``.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from add_gym_torch.envs.domain_rand import DRConfig
from add_gym_torch.envs.imitation import ImitationEnv, TaskConfig
from add_gym_torch.kinematics.char_model import load_char_model
from add_gym_torch.learning.add_agent import ADDAgent, AgentConfig
from add_gym_torch.motion.motion_lib import load_motion_lib
from add_gym_torch.parallel.mesh import Dist
from add_gym_torch.physics.engine import EngineParams
from add_gym_torch.physics.model import attach_geoms, build_physics_model
from add_gym_torch.physics.testing import MOTION_JOINT_ORDER
from add_gym_torch.robot import build_pd_gains
from add_gym_torch.utils.assets import asset_path
from add_gym_torch.utils.device import resolve_device


def _resolve_motion_file(path: str) -> str:
    """A motion file or manifest: as given, package-relative, or under the
    asset root."""
    if os.path.exists(path):
        return path
    pkg_rel = os.path.join(os.path.dirname(os.path.abspath(__file__)), path)
    if os.path.exists(pkg_rel):
        return pkg_rel
    return asset_path(path)


def _use_kernel(setting, device: torch.device, fused: bool = True) -> bool:
    """engine.kernel: auto | on | off (YAML may hand over on/off as bools).
    ``auto`` is the kernel on a CUDA device unless ``fused`` is off."""
    if isinstance(setting, str):
        low = setting.lower()
        if low == "auto":
            return device.type == "cuda" and fused
        if low in ("on", "true", "1"):
            setting = True
        elif low in ("off", "false", "0"):
            setting = False
        else:
            raise ValueError(f"engine.kernel must be auto/on/off, got {setting!r}")
    if setting and not fused:
        raise ValueError("engine.kernel=on with engine.fused=false: the kernel needs fused=True")
    if setting and device.type != "cuda":
        raise ValueError("engine.kernel=on needs a CUDA device")
    return bool(setting)


def build_env(cfg: Dict, device="cuda", dist: Dist | None = None) -> ImitationEnv:
    """The env on ``device``.  Under a ``dist`` of more than one rank it
    holds the rank's share of the global ``engine.num_envs`` (which the
    world size must divide) and steps it through the sharded wrappers of
    the kernel or the plain step; ``device`` must then be the rank's."""
    device = resolve_device(device)
    shard = None
    if dist is not None and dist.world_size > 1:
        if device != dist.device:
            raise ValueError(f"rank {dist.rank} runs on {dist.device}, not {device}")
        shard = dist.shard(int(cfg.get("engine", {}).get("num_envs", 256)))
    robot_cfg = cfg.get("robot", {})
    engine_cfg = cfg.get("engine", {})
    task_cfg = cfg.get("task", {})

    mjcf = asset_path(robot_cfg.get("asset_path", "g1_description/g1_29.xml"))
    char = load_char_model(mjcf)
    model = build_physics_model(mjcf, char)
    if bool(engine_cfg.get("general_narrowphase", False)):
        model = attach_geoms(model, mjcf)

    kp, kv = build_pd_gains(
        model,
        joint_cfg=robot_cfg.get("joints"),
        gain_scale=robot_cfg.get("gain_scale", 1.2),
    )
    params = EngineParams(
        kp=torch.as_tensor(kp, device=device),
        kv=torch.as_tensor(kv, device=device),
        ctrl_dt=float(engine_cfg.get("ctrl_dt", 0.01)),
        substeps=int(engine_cfg.get("substeps", 4)),
        max_torque=float(engine_cfg.get("max_torque", 200.0)),
        max_target_delta=float(engine_cfg.get("max_target_delta", 0.5)),
        position_limit_margin=float(engine_cfg.get("position_limit_margin", 1e-4)),
        contact_timeconst=float(engine_cfg.get("contact_timeconst", 0.02)),
        contact_dampratio=float(engine_cfg.get("contact_dampratio", 1.0)),
        friction_mu=float(engine_cfg.get("friction_mu", 1.0)),
    )

    motion = load_motion_lib(
        _resolve_motion_file(task_cfg.get("motion_file", "motions/dance1_subject3.motion")),
        task_cfg.get("motion_joint_order", MOTION_JOINT_ORDER),
        char,
        dt=params.ctrl_dt,
        device=device,
    )

    sampler_cfg = task_cfg.get("sampler", {}) or {}
    task = TaskConfig(
        max_episode_length=float(task_cfg.get("max_episode_length", 20)),
        global_obs=bool(task_cfg.get("global_obs", True)),
        root_height_obs=bool(task_cfg.get("root_height_obs", True)),
        pose_termination=bool(task_cfg.get("pose_termination", True)),
        pose_termination_dist=float(task_cfg.get("pose_termination_dist", 1.0)),
        enable_phase_obs=bool(task_cfg.get("enable_phase_obs", False)),
        enable_tar_obs=bool(task_cfg.get("enable_tar_obs", True)),
        num_phase_encoding=int(task_cfg.get("num_phase_encoding", 4)),
        tar_obs_steps=tuple(task_cfg.get("tar_obs_steps", (1, 2, 3, 4, 5, 6))),
        num_disc_obs_steps=int(task_cfg.get("num_disc_obs_steps", 3)),
        rand_reset=bool(task_cfg.get("rand_reset", True)),
        enable_early_termination=bool(task_cfg.get("enable_early_termination", True)),
        enable_vel_obs=bool(task_cfg.get("enable_vel_obs", False)),
        contact_bodies=tuple(task_cfg.get("contact_bodies", ())),
        reward_pose_w=float(task_cfg.get("reward_pose_w", 0.5)),
        reward_vel_w=float(task_cfg.get("reward_vel_w", 0.1)),
        reward_root_pose_w=float(task_cfg.get("reward_root_pose_w", 0.15)),
        reward_root_vel_w=float(task_cfg.get("reward_root_vel_w", 0.1)),
        reward_pose_scale=float(task_cfg.get("reward_pose_scale", 0.25)),
        reward_vel_scale=float(task_cfg.get("reward_vel_scale", 0.01)),
        reward_root_pose_scale=float(task_cfg.get("reward_root_pose_scale", 5.0)),
        reward_root_vel_scale=float(task_cfg.get("reward_root_vel_scale", 1.0)),
        sampler_num_segments=int(sampler_cfg.get("num_segments", 20)),
        sampler_temperature=sampler_cfg.get("temperature"),
    )
    # DRConfig holds the defaults of the keys the block leaves out
    dr = DRConfig(**{
        k: bool(v) if k == "enabled" else tuple(float(x) for x in v)
        for k, v in (engine_cfg.get("domain_rand") or {}).items()
    })
    fused = bool(engine_cfg.get("fused", True))
    return ImitationEnv(
        model, motion, params, task,
        kernel=_use_kernel(engine_cfg.get("kernel", "auto"), device, fused),
        fused=fused,
        device=device,
        dr=dr,
        shard=shard,
        char=char,
    )


def build_agent(cfg: Dict, env: ImitationEnv, generator: torch.Generator | None = None,
                dist: Dist | None = None) -> ADDAgent:
    """The agent on ``env``'s device; without ``generator`` it draws from a
    generator on that device seeded with ``cfg["seed"]``.  ``dist`` (the
    env's) makes its batch statistics and gradients global over the ranks."""
    a = cfg.get("agent", {})
    agent_cfg = AgentConfig(
        discount=float(a.get("discount", 0.99)),
        td_lambda=float(a.get("td_lambda", 0.95)),
        steps_per_iter=int(a.get("steps_per_iter", 32)),
        update_epochs=int(a.get("update_epochs", 5)),
        batch_size=int(a.get("batch_size", 4)),
        ppo_clip_ratio=float(a.get("ppo_clip_ratio", 0.2)),
        norm_adv_clip=float(a.get("norm_adv_clip", 4.0)),
        action_bound_weight=float(a.get("action_bound_weight", 10.0)),
        action_entropy_weight=float(a.get("action_entropy_weight", 0.0)),
        action_reg_weight=float(a.get("action_reg_weight", 0.0)),
        critic_loss_weight=float(a.get("critic_loss_weight", 1.0)),
        learning_rate=float(a.get("learning_rate", 1e-4)),
        grad_clip=float(a.get("grad_clip", 1.0)),
        optimizer=a.get("optimizer", "adam"),
        momentum=float(a.get("momentum", 0.9)),
        disc_loss_weight=float(a.get("disc_loss_weight", 0.5)),
        disc_logit_reg=float(a.get("disc_logit_reg", 0.01)),
        disc_grad_penalty=float(a.get("disc_grad_penalty", 20.0)),
        disc_weight_decay=float(a.get("disc_weight_decay", 1e-4)),
        disc_reward_scale=float(a.get("disc_reward_scale", 2.0)),
        task_reward_weight=float(a.get("task_reward_weight", 0.0)),
        disc_reward_weight=float(a.get("disc_reward_weight", 1.0)),
        action_std=float(a.get("action_std", 0.05)),
        actor_std_type=a.get("actor_std_type", "fixed"),
        exp_prob=float(a.get("exp_prob", 1.0)),
        exp_prob_end=float(a.get("exp_prob_end", 1.0)),
        exp_anneal_samples=float(a.get("exp_anneal_samples", float("inf"))),
        normalizer_samples=float(a.get("normalizer_samples", 1e8)),
        disc_mode=a.get("disc_mode", "add"),
        actor_net=a.get("actor_net", "fc_3layers_1024units"),
        critic_net=a.get("critic_net", "fc_3layers_1024units"),
        disc_net=a.get("disc_net", "fc_2layers_1024units"),
        actor_init_output_scale=float(a.get("actor_init_output_scale", 0.01)),
        mixed_precision=bool(a.get("mixed_precision", False)),
        disc_mixed_precision=bool(a.get("disc_mixed_precision", False)),
        minibatch_blocks=a.get("minibatch_blocks", "auto"),
    )
    if generator is None:
        generator = torch.Generator(device=env.device)
        generator.manual_seed(int(cfg.get("seed", 0)))
    return ADDAgent(env, agent_cfg, generator, dist)
