"""Imitation task reward (pure function).

Counterpart of ``add_gym_tpu/envs/reward.py``: weighted exp-of-squared-
error terms for pose / velocity / root pose / root velocity against the
reference motion frame.
"""

from __future__ import annotations

import torch

import add_gym_torch.mathx.rotations as rot


def _to_local_root(root_rot, root_vel, root_ang_vel):
    """Heading-local root quantities."""
    heading_inv = rot.calc_heading_quat_inv(root_rot)
    return (
        rot.quat_mul(heading_inv, root_rot),
        rot.quat_rotate(heading_inv, root_vel),
        rot.quat_rotate(heading_inv, root_ang_vel),
    )


def compute_reward(
    root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
    tar_root_pos, tar_root_rot, tar_root_vel, tar_root_ang_vel,
    tar_dof_pos, tar_dof_vel, dof_err_w,
    *, track_root_h: bool, track_root: bool,
    pose_w: float, vel_w: float, root_pose_w: float, root_vel_w: float,
    pose_scale: float, vel_scale: float, root_pose_scale: float,
    root_vel_scale: float,
):
    pose_diff = tar_dof_pos - dof_pos
    pose_err = torch.sum(dof_err_w * pose_diff * pose_diff, dim=-1)

    vel_diff = tar_dof_vel - dof_vel
    vel_err = torch.sum(dof_err_w * vel_diff * vel_diff, dim=-1)

    root_pos_diff = tar_root_pos - root_pos
    keep = torch.ones(3, dtype=root_pos.dtype, device=root_pos.device)
    if not track_root:
        keep[0:2] = 0.0
    if not track_root_h:
        keep[2] = 0.0
    root_pos_diff = root_pos_diff * keep
    root_pos_err = torch.sum(root_pos_diff * root_pos_diff, dim=-1)

    if not track_root:
        root_rot, root_vel, root_ang_vel = _to_local_root(root_rot, root_vel, root_ang_vel)
        tar_root_rot, tar_root_vel, tar_root_ang_vel = _to_local_root(
            tar_root_rot, tar_root_vel, tar_root_ang_vel
        )

    root_rot_err = rot.quat_diff_angle(root_rot, tar_root_rot) ** 2

    root_vel_err = torch.sum((tar_root_vel - root_vel) ** 2, dim=-1)
    root_ang_vel_err = torch.sum((tar_root_ang_vel - root_ang_vel) ** 2, dim=-1)

    pose_r = torch.exp(-pose_scale * pose_err)
    vel_r = torch.exp(-vel_scale * vel_err)
    root_pose_r = torch.exp(-root_pose_scale * (root_pos_err + 0.1 * root_rot_err))
    root_vel_r = torch.exp(-root_vel_scale * (root_vel_err + 0.1 * root_ang_vel_err))

    return pose_w * pose_r + vel_w * vel_r + root_pose_w * root_pose_r + root_vel_w * root_vel_r
