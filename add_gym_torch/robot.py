"""Robot configuration: regex tag lookups, PD gain tables and the
:class:`Robot` facade.

Counterpart of ``add_gym_tpu/robot.py``: link and joint regex tags from
the robot config drive per-group PD gains (plain numpy arrays handed to
the engine) and the tag lookups; :class:`Robot` holds the static pieces
(lookups, gains, default pose, action space) with pure helpers over a
``SimState`` of tensors.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

import torch

from add_gym_torch.physics.model import PhysicsModel

# hard-coded per-group gains
_GROUP_GAINS = {
    "ankle": 120.0,
    "knee": 120.0,
    "hip": 80.0,
    "core": 50.0,
    "arm": 50.0,
    "hand": 20.0,
}
_DEFAULT_GAIN = 100.0

DEFAULT_JOINT_TAGS = [
    {"match": r"root_joint|floating_base_joint", "tags": ["base"]},
    {"match": r".*(waist).*", "tags": ["core", "upper_body"]},
    {"match": r".*(hip|knee|ankle).*", "tags": ["lower_body", "leg"]},
    {"match": r".*(hip).*", "tags": ["hip"]},
    {"match": r".*(knee).*", "tags": ["knee"]},
    {"match": r".*(ankle).*", "tags": ["ankle"]},
    {"match": r".*(shoulder|elbow|wrist).*", "tags": ["upper_body", "arm"]},
    {"match": r".*(hand|thumb).*", "tags": ["upper_body", "hand"]},
]


def _lookup(names: List[str], cfg) -> Dict[str, List[int]]:
    lookup: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        for entry in cfg:
            if re.fullmatch(entry["match"], name):
                for tag in entry["tags"]:
                    lookup.setdefault(tag, []).append(i)
    return lookup


def build_joint_lookup(joint_names: List[str], joint_cfg=None) -> Dict[str, List[int]]:
    """Tag -> dof indices, via regex fullmatch."""
    return _lookup(joint_names, joint_cfg or DEFAULT_JOINT_TAGS)


DEFAULT_LINK_TAGS = [
    {"match": r"pelvis", "tags": ["base", "core"]},
    {"match": r".*(waist|torso).*", "tags": ["core", "upper_body"]},
    {"match": r".*(hip|knee).*", "tags": ["lower_body", "leg"]},
    {"match": r".*(ankle).*", "tags": ["lower_body", "leg", "feet"]},
    {"match": r".*(shoulder|elbow|wrist).*", "tags": ["upper_body", "arm"]},
    {"match": r".*(hand|thumb).*", "tags": ["upper_body", "hand"]},
]


def build_link_lookup(body_names: List[str], link_cfg=None) -> Dict[str, List[int]]:
    """Tag -> body indices, via regex fullmatch."""
    return _lookup(body_names, link_cfg or DEFAULT_LINK_TAGS)


def build_pd_gains(model: PhysicsModel, joint_cfg=None, gain_scale: float = 1.2):
    """kp/kv arrays for the engine (damping 2*sqrt(kp))."""
    joint_names = list(model.joint_names)
    lookup = build_joint_lookup(joint_names, joint_cfg)

    kp = np.full(model.nd, _DEFAULT_GAIN, np.float32)
    covered = np.zeros(model.nd, bool)
    for tag, gain in _GROUP_GAINS.items():
        idx = lookup.get(tag, [])
        kp[idx] = gain
        covered[idx] = True
    if not covered.all():
        missing = [joint_names[i] for i in np.where(~covered)[0]]
        raise ValueError(f"Joints without PD gain assignment: {missing}")
    kp *= gain_scale
    kv = 2.0 * np.sqrt(kp)
    return kp, kv


class Robot:
    """The robot's static description (tag lookups, gains, default pose,
    action space) and pure helpers for the stateful queries; state flows
    through ``SimState`` tensors."""

    def __init__(
        self,
        model: PhysicsModel,
        link_cfg=None,
        joint_cfg=None,
        gain_scale: float = 1.2,
        default_angles: Dict[str, float] | None = None,
        ground_clearance: float = 1e-3,
    ):
        self.model = model
        self.link_lookup = build_link_lookup(model.body_names, link_cfg)
        self.joint_lookup = build_joint_lookup(list(model.joint_names), joint_cfg)
        self.kp, self.kv = build_pd_gains(model, joint_cfg, gain_scale)

        # default joint angles with per-joint overrides
        self.default_dof_pos = np.zeros(model.nd, np.float32)
        for joint_name, angle in (default_angles or {}).items():
            di = list(model.joint_names).index(joint_name)
            self.default_dof_pos[di] = float(angle)

        # base height from the collision geometry's ground clearance at the
        # default pose
        self.base_init_pos = self._init_pos_from_geometry(ground_clearance)
        self.base_init_quat = np.asarray([1.0, 0, 0, 0], np.float32)

        # action space = joint-limit mid +- 1.4 x half-range
        lim = np.asarray(model.dof_limit)
        mid = 0.5 * (lim[:, 0] + lim[:, 1])
        scale = 1.4 * np.maximum(np.abs(lim[:, 1] - mid), np.abs(lim[:, 0] - mid))
        self.action_low = (mid - scale).astype(np.float32)
        self.action_high = (mid + scale).astype(np.float32)

    def _init_pos_from_geometry(self, clearance: float) -> np.ndarray:
        from dataclasses import replace

        from add_gym_torch.physics.engine import default_state, forward_kinematics

        s = default_state(self.model, 1)
        s = replace(s, dof_pos=torch.as_tensor(self.default_dof_pos)[None])
        bp, br = forward_kinematics(self.model, s)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
        cp_body = torch.as_tensor(self.model.cp_body, dtype=torch.int64)
        cpw = bp[:, cp_body] + torch.einsum("npij,pj->npi", br[:, cp_body], f32(self.model.cp_pos))
        low = float((cpw[..., 2] - f32(self.model.cp_radius)).min())
        return np.asarray([0.0, 0.0, -low + clearance], np.float32)

    # ------------------------------------------------------------- lookups

    def links_by_tag(self, tag: str) -> List[int]:
        return self.link_lookup[tag]

    def joints_by_tag(self, tag: str) -> List[int]:
        return self.joint_lookup[tag]

    # ------------------------------------------ pure state accessors (SimState)

    @staticmethod
    def base_pos(sim):
        return sim.root_pos

    @staticmethod
    def base_quat(sim):
        return sim.root_quat

    @staticmethod
    def dof_pos(sim):
        return sim.dof_pos

    @staticmethod
    def dof_vel(sim):
        return sim.dof_vel

    def body_poses(self, sim):
        """World position and orientation of every body through the
        engine's FK: ([N, nb, 3], [N, nb, 3, 3])."""
        from add_gym_torch.physics.engine import forward_kinematics

        return forward_kinematics(self.model, sim)

    def ground_contact_flags(self, body_contact, tag_or_ids="feet"):
        """Per-env bool: any tagged body touching the ground.

        ``body_contact`` is the [N, nb] normal-force map from the engine
        step (a tensor or an array; the result is of the same kind).
        """
        ids = self.links_by_tag(tag_or_ids) if isinstance(tag_or_ids, str) else list(tag_or_ids)
        return (body_contact[:, ids] > 0).any(-1)

    def default_sim_state(self, num_envs: int, device="cpu"):
        """Standing ``SimState`` on ``device`` at the geometry-derived init
        height."""
        from dataclasses import replace

        from add_gym_torch.physics.engine import default_state

        s = default_state(self.model, num_envs, device=device)
        pose = torch.as_tensor(self.default_dof_pos, device=device).expand(num_envs, self.model.nd)
        return replace(
            s,
            root_pos=torch.as_tensor(self.base_init_pos, device=device).expand(num_envs, 3).clone(),
            dof_pos=pose.clone(),
            pd_target=pose.clone(),
        )
