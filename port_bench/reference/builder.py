"""Assemble the reference's env from a composed config dict, on an
explicit ``device``: it always steps through the reference-layout engine,
one rank holding every env.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from port_bench.reference.envs.domain_rand import DRConfig
from port_bench.reference.envs.imitation import ImitationEnv, TaskConfig
from port_bench.reference.kinematics.char_model import load_char_model
from port_bench.reference.motion.motion_lib import load_motion_lib
from port_bench.reference.physics.engine import EngineParams
from port_bench.reference.physics.model import build_physics_model
from port_bench.reference.robot import build_pd_gains
from port_bench.reference.utils.assets import asset_path
from port_bench.reference.utils.device import resolve_device


def _resolve_motion_file(path: str) -> str:
    """A motion file or manifest: as given, package-relative, or under the
    asset root."""
    if os.path.exists(path):
        return path
    pkg_rel = os.path.join(os.path.dirname(os.path.abspath(__file__)), path)
    if os.path.exists(pkg_rel):
        return pkg_rel
    return asset_path(path)


def build_env(cfg: Dict, device="cuda") -> ImitationEnv:
    """The env on ``device``."""
    device = resolve_device(device)
    robot_cfg = cfg.get("robot", {})
    engine_cfg = cfg.get("engine", {})
    task_cfg = cfg.get("task", {})

    mjcf = asset_path(robot_cfg.get("asset_path", "g1_description/g1_29.xml"))
    char = load_char_model(mjcf)
    model = build_physics_model(mjcf, char)
    if bool(engine_cfg.get("general_narrowphase", False)):
        raise NotImplementedError("the reference has no geom-geom narrowphase")

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
        task_cfg["motion_joint_order"],
        char,
        dt=params.ctrl_dt,
        device=device,
    )

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
    )
    # DRConfig holds the defaults of the keys the block leaves out
    dr = DRConfig(**{
        k: bool(v) if k == "enabled" else tuple(float(x) for x in v)
        for k, v in (engine_cfg.get("domain_rand") or {}).items()
    })
    return ImitationEnv(
        model, motion, params, task,
        device=device,
        dr=dr,
        char=char,
    )
