"""Observation builders for the imitation task (pure functions on tensors).

Counterpart of ``add_gym_tpu/envs/obs.py``.  Default task config: global
obs, root height obs, target obs at steps 1..6, phase and velocity obs off,
disc history of 3 steps.
"""

from __future__ import annotations

import math

import torch

import port_bench.reference.mathx.rotations as rot


def compute_char_obs(
    root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
    enable_vel_obs: bool, global_obs: bool, root_height_obs: bool,
):
    """Character state obs."""
    obs = []
    if root_height_obs:
        obs.append(root_pos[..., 2:3])

    if global_obs:
        root_rot_obs = rot.quat_to_tan_norm(root_rot)
    else:
        heading_inv = rot.calc_heading_quat_inv(root_rot)
        root_rot_obs = rot.quat_to_tan_norm(rot.quat_mul(heading_inv, root_rot))
    obs.append(root_rot_obs)
    obs.append(dof_pos)

    if enable_vel_obs:
        if global_obs:
            obs += [root_vel, root_ang_vel, dof_vel]
        else:
            heading_inv = rot.calc_heading_quat_inv(root_rot)
            obs += [
                rot.quat_rotate(heading_inv, root_vel),
                rot.quat_rotate(heading_inv, root_ang_vel),
                dof_vel,
            ]
    return torch.cat(obs, dim=-1)


def compute_tar_obs(
    ref_root_pos, ref_root_rot, tar_root_pos, tar_root_rot, tar_dof_pos,
    global_obs: bool, root_height_obs: bool,
):
    """Future-target obs relative to a reference frame; tar_* carry a steps
    axis [..., K, d], ref_* are [..., d]."""
    root_pos_obs = tar_root_pos - ref_root_pos[..., None, :]

    root_rot = tar_root_rot
    if not global_obs:
        heading_inv = rot.calc_heading_quat_inv(ref_root_rot)[..., None, :]
        heading_inv = heading_inv.expand(tar_root_rot.shape)
        root_pos_obs = rot.quat_rotate(heading_inv, root_pos_obs)
        root_rot = rot.quat_mul(heading_inv, tar_root_rot)

    if root_height_obs:
        root_pos_obs = torch.cat([root_pos_obs[..., :2], tar_root_pos[..., 2:3]], dim=-1)
    else:
        root_pos_obs = root_pos_obs[..., :2]

    root_rot_obs = rot.quat_to_tan_norm(root_rot)
    obs = torch.cat([root_pos_obs, root_rot_obs, tar_dof_pos], dim=-1)
    return obs.reshape(obs.shape[:-2] + (obs.shape[-2] * obs.shape[-1],))


def compute_phase_obs(phase, num_phase_encoding: int):
    """Sinusoidal phase encoding."""
    phase_obs = phase[..., None]
    if num_phase_encoding > 0:
        pe_scale = 2.0 * math.pi * (2.0 ** torch.arange(
            num_phase_encoding, dtype=phase.dtype, device=phase.device))
        pe_val = phase[..., None] * pe_scale
        phase_obs = torch.cat([phase_obs, torch.sin(pe_val), torch.cos(pe_val)], dim=-1)
    return phase_obs


def compute_disc_obs(
    root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
    enable_vel_obs: bool, global_obs: bool,
):
    """Discriminator obs over a history window [..., H, d] -> flat."""
    pos = root_pos
    if not global_obs:
        pos = torch.cat([torch.zeros_like(pos[..., 0:2]), pos[..., 2:]], dim=-1)
    parts = [pos, rot.quat_to_tan_norm(root_rot), dof_pos]
    if enable_vel_obs:
        if global_obs:
            parts += [root_vel, root_ang_vel, dof_vel]
        else:
            heading_inv = rot.calc_heading_quat_inv(root_rot)
            parts += [
                rot.quat_rotate(heading_inv, root_vel),
                rot.quat_rotate(heading_inv, root_ang_vel),
                dof_vel,
            ]
    obs = torch.cat(parts, dim=-1)
    return obs.reshape(obs.shape[:-2] + (obs.shape[-2] * obs.shape[-1],))


def compute_add_obs(
    root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
    phase, tar_root_pos, tar_root_rot, tar_dof_pos,
    *, enable_vel_obs: bool, global_obs: bool, root_height_obs: bool,
    enable_phase_obs: bool, num_phase_encoding: int, enable_tar_obs: bool,
):
    """Full actor/critic observation."""
    obs = [
        compute_char_obs(
            root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
            enable_vel_obs, global_obs, root_height_obs,
        )
    ]
    if enable_phase_obs:
        obs.append(compute_phase_obs(phase, num_phase_encoding))
    if enable_tar_obs:
        if global_obs:
            ref_root_pos, ref_root_rot = root_pos, root_rot
        else:
            ref_root_pos = tar_root_pos[..., 0, :]
            ref_root_rot = tar_root_rot[..., 0, :]
        obs.append(
            compute_tar_obs(
                ref_root_pos, ref_root_rot, tar_root_pos, tar_root_rot,
                tar_dof_pos, global_obs, root_height_obs,
            )
        )
    return torch.cat(obs, dim=-1)
