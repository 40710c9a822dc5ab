"""Motion library: multi-clip mocap store with precomputed per-step tables.

Counterpart of ``add_gym_tpu/motion/motion_lib.py``: every clip is
precomputed at ctrl-dt resolution into flat tensors on the device and
served by integer gather.  Loading and precompute run once on the host
CPU; :func:`load_motion_lib` then moves the tables to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch
import yaml

import add_gym_torch.mathx.rotations as rot
from add_gym_torch.kinematics.char_model import CharModel
from add_gym_torch.motion.motion_file import LoopMode, extract_pose_data, load_motion


@dataclass(frozen=True)
class MotionLib:
    """Immutable motion dataset; every tensor lives on one device."""

    dt: float
    dt_inv: int
    num_motions: int

    weights: torch.Tensor        # [M] normalized sampling weights
    lengths: torch.Tensor        # [M] seconds
    loop_modes: torch.Tensor     # [M] int (LoopMode)
    # packed step rows [S, 13+2D] = [rp rr rv rav dp dv] and per-motion
    # metadata [M, 7] = [len wrap max_frame start dx dy dz]
    step_all: torch.Tensor
    meta_all: torch.Tensor

    def get_num_motions(self) -> int:
        return self.num_motions

    def get_total_length(self) -> float:
        return float(torch.sum(self.lengths))

    # --------------------------------------------------------------- lookup

    def get_motion_rows(self, motion_ids, motion_times):
        """Packed row(s) [..., 13+2D] for (motion_id, time), WRAP offset applied.

        Frame rule: ``floor(t * dt_inv + 0.25)``, clamped per motion, as in
        the JAX package (the +0.25-frame nudge absorbs f32 grid noise of
        dt-aligned times).
        """
        meta = self.meta_all[motion_ids]                  # [..., 7]
        length, wrap_f = meta[..., 0], meta[..., 1]
        max_frame = meta[..., 2]
        wrap = wrap_f != 0.0
        loops = torch.floor(torch.clamp_min(motion_times, 0.0) / length)
        t = torch.where(wrap, motion_times - loops * length, motion_times)

        frame = torch.floor(t * self.dt_inv + 0.25)
        frame = torch.minimum(torch.clamp_min(frame, 0.0), max_frame)
        idx = (frame + meta[..., 3]).to(torch.int64)

        offset = torch.where(
            wrap[..., None], loops[..., None] * meta[..., 4:7], torch.zeros_like(meta[..., 4:7])
        )
        row = self.step_all[idx]                          # [..., 13+2D]
        return torch.cat([row[..., 0:3] + offset, row[..., 3:]], dim=-1)

    @staticmethod
    def split_rows(row):
        """Packed row [..., 13+2D] -> (rp, rr, rv, rav, dp, dv)."""
        D = (row.shape[-1] - 13) // 2
        return (
            row[..., 0:3],
            row[..., 3:7],
            row[..., 7:10],
            row[..., 10:13],
            row[..., 13:13 + D],
            row[..., 13 + D:13 + 2 * D],
        )

    def get_motion_step(self, motion_ids, motion_times):
        """(rp, rr, rv, rav, dp, dv) at (motion_id, time); WRAP clips loop and
        accumulate the per-loop root displacement."""
        return self.split_rows(self.get_motion_rows(motion_ids, motion_times))

    def calc_motion_phase(self, motion_ids, times):
        motion_len = self.lengths[motion_ids]
        phase = times / motion_len
        wrapped = phase - torch.floor(phase)
        phase = torch.where(self.loop_modes[motion_ids] == int(LoopMode.WRAP), wrapped, phase)
        return torch.clamp(phase, 0.0, 1.0)

    def get_motion_length(self, motion_ids):
        return self.lengths[motion_ids]

    def get_motion_loop_mode(self, motion_ids):
        return self.loop_modes[motion_ids]

    # ------------------------------------------------------------- sampling

    def sample_motions(self, n: int, generator: torch.Generator | None = None):
        """Weighted clip sampling (with replacement)."""
        return torch.multinomial(self.weights, n, replacement=True, generator=generator)

    def sample_time(self, motion_ids, generator: torch.Generator | None = None):
        """Uniform time in [0, len), quantized down to ``dt``."""
        phase = torch.rand(motion_ids.shape, generator=generator, device=self.lengths.device)
        t = phase * self.lengths[motion_ids]
        return torch.floor(t / self.dt) * self.dt


# ------------------------------------------------------------------ loading


def _fetch_motion_files(motion_file: str):
    """Single file or YAML manifest of {file, weight} (entries resolve
    through the asset root)."""
    if motion_file.endswith(".yaml"):
        from add_gym_torch.utils.assets import asset_path

        with open(motion_file) as f:
            cfg = yaml.safe_load(f)
        files = [asset_path(m["file"]) for m in cfg["motions"]]
        weights = [float(m["weight"]) for m in cfg["motions"]]
        if any(w < 0 for w in weights):
            raise ValueError("motion weights must be >= 0")
        return files, weights
    return [motion_file], [1.0]


def _interp_frames(char: CharModel, root_pos, root_rot, joint_rot, times, length):
    """Interpolate per-source-frame data at the given times (CLAMP phase):
    lerp root pos, slerp root and joint rots, joint rots back to dofs."""
    num_frames = root_pos.shape[0]
    phase = torch.clamp(times / length, 0.0, 1.0)
    fidx = phase * (num_frames - 1)
    idx0 = torch.floor(fidx).to(torch.int64)
    idx1 = torch.clamp_max(idx0 + 1, num_frames - 1)
    blend = fidx - idx0

    rp = (1.0 - blend[:, None]) * root_pos[idx0] + blend[:, None] * root_pos[idx1]
    rr = rot.slerp(root_rot[idx0], root_rot[idx1], blend)
    jr = rot.slerp(joint_rot[idx0], joint_rot[idx1], blend[:, None].expand(-1, joint_rot.shape[1]))
    dof = char.rot_to_dof(jr)
    return rp, rr, jr, dof, idx0


def load_motion_lib(
    motion_file: str,
    motion_order: Sequence[str],
    char: CharModel,
    dt: float,
    device="cpu",
) -> MotionLib:
    """Load clips, reorder joints to the BFS client order, precompute tables
    on the host and move them to ``device``."""
    files, weights = _fetch_motion_files(motion_file)
    kin_order = char.get_joint_order()[1:]
    col_map = np.asarray([list(motion_order).index(n) for n in kin_order], np.int64)

    lengths: List[float] = []
    loop_modes: List[int] = []
    rows: List[torch.Tensor] = []
    num_steps: List[int] = []
    root_pos_delta: List[np.ndarray] = []
    f32 = torch.float32

    for path in files:
        clip = load_motion(path)
        fps = float(clip.fps)
        frames = np.asarray(clip.frames, np.float64)
        root_pos_np, root_rot_np, joint_dof_np = extract_pose_data(frames)
        joint_dof_np = joint_dof_np[:, col_map]

        root_pos = torch.as_tensor(root_pos_np, dtype=f32)
        root_rot = rot.quat_normalize(torch.as_tensor(root_rot_np, dtype=f32))
        joint_dof = torch.as_tensor(joint_dof_np, dtype=f32)
        joint_rot = rot.quat_pos(char.dof_to_rot(joint_dof))

        length = float(frames.shape[0] - 1) / fps

        # per-source-frame velocities (finite differences, last repeated)
        root_vel = fps * (root_pos[1:] - root_pos[:-1])
        root_vel = torch.cat([root_vel, root_vel[-1:]], dim=0)
        drot = rot.quat_diff(root_rot[:-1], root_rot[1:])
        root_ang_vel = fps * rot.quat_to_exp_map(drot)
        root_ang_vel = torch.cat([root_ang_vel, root_ang_vel[-1:]], dim=0)
        dof_vel = char.compute_frame_dof_vel(joint_rot, 1.0 / fps)

        # precompute at ctrl-dt resolution
        times = torch.as_tensor(np.arange(0.0, length, dt), dtype=f32)
        rp, rr, _, dp, idx0 = _interp_frames(char, root_pos, root_rot, joint_rot, times, length)
        rows.append(torch.cat(
            [rp, rr, root_vel[idx0], root_ang_vel[idx0], dp, dof_vel[idx0]], dim=-1
        ))

        lengths.append(length)
        loop_modes.append(int(clip.loop_mode))
        num_steps.append(int(times.shape[0]))
        root_pos_delta.append((root_pos[-1] - root_pos[0]).numpy())

    w = np.asarray(weights, np.float32)
    w = w / w.sum()
    num_steps_arr = np.asarray(num_steps, np.int64)
    start_idx = np.concatenate([[0], np.cumsum(num_steps_arr)[:-1]]).astype(np.int64)
    meta_all = np.column_stack(
        [
            np.asarray(lengths, np.float32),
            (np.asarray(loop_modes) == int(LoopMode.WRAP)).astype(np.float32),
            (num_steps_arr - 1).astype(np.float32),
            start_idx.astype(np.float32),
            np.stack(root_pos_delta),
        ]
    ).astype(np.float32)

    dev = lambda x, dtype=None: torch.as_tensor(x, dtype=dtype, device=device)
    return MotionLib(
        dt=dt,
        dt_inv=round(1.0 / dt),
        num_motions=len(files),
        weights=dev(w),
        lengths=dev(np.asarray(lengths, np.float32)),
        loop_modes=dev(np.asarray(loop_modes, np.int64)),
        step_all=torch.cat(rows).to(device),
        meta_all=dev(meta_all),
    )
