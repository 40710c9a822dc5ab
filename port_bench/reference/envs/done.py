"""Episode termination flags (pure function).

Counterpart of ``add_gym_tpu/envs/done.py``: TIME on episode length, SUCC
at motion end for non-WRAP clips, FAIL on disallowed ground contact or pose
error; contact flags come straight from the engine's contact forces.
"""

from __future__ import annotations

import enum

import torch


class DoneFlags(enum.IntEnum):
    NULL = 0
    FAIL = 1
    SUCC = 2
    TIME = 3


def compute_done(
    time, root_pos, dof_pos, tar_root_pos, tar_dof_pos,
    body_contact,          # [N, nb] normal force per body from the engine
    motion_times, motion_len, motion_len_term,
    *, ep_len: float, noncontact_body_mask,  # [nb] bool tensor: bodies that must not touch
    pose_termination: bool, pose_termination_dist: float,
    enable_early_termination: bool, track_root: bool,
):
    done = torch.full(time.shape, int(DoneFlags.NULL), dtype=torch.int32, device=time.device)
    flag = lambda f: torch.full_like(done, int(f))

    done = torch.where(time >= ep_len, flag(DoneFlags.TIME), done)

    motion_end = (motion_times >= motion_len) & motion_len_term
    done = torch.where(motion_end, flag(DoneFlags.SUCC), done)

    if enable_early_termination:
        failed = torch.any((body_contact > 0.0) & noncontact_body_mask[None, :], dim=-1)

        if pose_termination:
            dof_err = torch.mean((tar_dof_pos - dof_pos) ** 2, dim=-1)
            pose_fail = dof_err > pose_termination_dist
            if track_root:
                root_err = torch.sum((tar_root_pos - root_pos) ** 2, dim=-1)
                pose_fail = pose_fail | (root_err > pose_termination_dist)
            failed = failed | pose_fail

        failed = failed & (time > 0.0)
        done = torch.where(failed, flag(DoneFlags.FAIL), done)

    return done
