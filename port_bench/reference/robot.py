"""Robot configuration: regex tag lookups and the per-group PD gain tables
handed to the engine.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np


from port_bench.reference.physics.model import PhysicsModel

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


