"""Motion clip file formats.

Counterpart of ``add_gym_tpu/motion/motion_file.py``.  ``.motion`` files
are CSV text, one frame per line of 36 floats: root pos (3) + root quat
stored **xyzw** at columns 3-6 + 29 joint angles, 30 fps.  The pickle
format is ``{"loop_mode": int, "fps": int, "frames": ndarray}``, which
:meth:`MotionClip.save` writes, so each package reads the other's clips.
CSV parsing goes through the native loader (``port_bench.reference.native``),
which falls back to numpy where it cannot be built.
"""

from __future__ import annotations

import enum
import pickle
from dataclasses import dataclass

import numpy as np


class LoopMode(enum.IntEnum):
    CLAMP = 0
    WRAP = 1


DEFAULT_FPS = 30


@dataclass
class MotionClip:
    loop_mode: LoopMode
    fps: float
    frames: np.ndarray  # [T, 36]

    def save(self, out_file: str) -> None:
        with open(out_file, "wb") as f:
            pickle.dump(
                {"loop_mode": int(self.loop_mode), "fps": self.fps, "frames": self.frames},
                f,
            )


def parse_motion_csv(path: str) -> np.ndarray:
    """Parse a ``.motion`` CSV into a [T, C] float64 array."""
    return np.atleast_2d(np.loadtxt(path, delimiter=",", dtype=np.float64))


def load_motion(path: str) -> MotionClip:
    """Load a ``.motion`` CSV (CLAMP, 30 fps) or a pickle clip this project wrote."""
    if path.endswith(".motion"):
        return MotionClip(loop_mode=LoopMode.CLAMP, fps=DEFAULT_FPS,
                          frames=parse_motion_csv(path))
    with open(path, "rb") as f:
        d = pickle.load(f)
    return MotionClip(
        loop_mode=LoopMode(d["loop_mode"]), fps=d["fps"], frames=np.asarray(d["frames"])
    )


def extract_pose_data(frame: np.ndarray):
    """Split a frame into (root_pos, root_rot_wxyz, joint_dof)."""
    root_pos = frame[..., 0:3]
    root_rot = frame[..., [6, 3, 4, 5]]
    joint_dof = frame[..., 7:]
    return root_pos, root_rot, joint_dof
