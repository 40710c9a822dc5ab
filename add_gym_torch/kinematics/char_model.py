"""Kinematic character model: MJCF skeleton -> static arrays + torch ops.

Counterpart of ``add_gym_tpu/kinematics/char_model.py``.  The parse result
is a frozen set of host numpy arrays (parents, local transforms, joint
axes, dof indexing) in breadth-first MJCF order; the conversions between
dof vectors and joint rotations and the forward kinematics run on torch
tensors of any device; :meth:`CharModel.export_mjcf` writes the skeleton
back out as MJCF text (the same text as the JAX package's).

Joint types: ROOT (free base), HINGE (1 dof) and FIXED; three consecutive
hinges consolidate into a SPHERICAL joint (3-dof exp-map).
"""

from __future__ import annotations

import enum
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

import add_gym_torch.mathx.rotations as rot


class JointType(enum.IntEnum):
    ROOT = 0
    HINGE = 1
    SPHERICAL = 2
    FIXED = 3


_DOF_DIMS = {JointType.ROOT: 0, JointType.HINGE: 1, JointType.SPHERICAL: 3, JointType.FIXED: 0}


@dataclass(frozen=True)
class CharModel:
    """Static skeleton description in BFS order (host numpy arrays).

    ``local_rotation`` is stored **xyzw**; use :meth:`local_rotation_wxyz`
    for math with :mod:`add_gym_torch.mathx.rotations`.
    """

    body_names: List[str]
    parent_indices: np.ndarray            # [nb] int, -1 for root
    local_translation: np.ndarray         # [nb, 3]
    local_rotation: np.ndarray            # [nb, 4] xyzw
    joint_names: List[str]                # [nb] per body (root joint named "root")
    joint_types: np.ndarray               # [nb] JointType int
    joint_axes: np.ndarray                # [nb, 3] (zeros for non-hinge)
    dof_offsets: np.ndarray               # [nb] start index of body's dofs
    dof_size: int
    _name_to_idx: dict = field(default_factory=dict)

    # ------------------------------------------------------------------ info

    @property
    def num_bodies(self) -> int:
        return len(self.body_names)

    def get_num_joints(self) -> int:
        return self.num_bodies

    def get_dof_size(self) -> int:
        return self.dof_size

    def get_body_id(self, name: str) -> int:
        return self._name_to_idx[name]

    def get_joint_id(self, body_name: str) -> int:
        # joint arrays exclude the root
        return self._name_to_idx[body_name] - 1

    def get_joint_order(self) -> List[str]:
        return list(self.joint_names)

    def get_parent_id(self, j: int) -> int:
        return int(self.parent_indices[j])

    def get_joint_dof_dim(self, j: int) -> int:
        return _DOF_DIMS[JointType(int(self.joint_types[j]))]

    def get_joint_dof_idx(self, j: int) -> int:
        return int(self.dof_offsets[j])

    def local_rotation_wxyz(self) -> np.ndarray:
        q = self.local_rotation
        return np.concatenate([q[..., 3:4], q[..., 0:3]], axis=-1)

    def _hinge_ids(self) -> np.ndarray:
        """Joint-array indices (0-based into [nb-1]) of hinge joints."""
        return np.where(self.joint_types[1:] == int(JointType.HINGE))[0]

    def _spherical_ids(self) -> np.ndarray:
        return np.where(self.joint_types[1:] == int(JointType.SPHERICAL))[0]

    def _const(self, x, like):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    # ----------------------------------------------------------- conversions

    def dof_to_rot(self, dof):
        """Per-joint rotation quats [..., nb-1, 4] from dof vector [..., dof_size]."""
        batch = dof.shape[:-1]
        nb1 = self.num_bodies - 1
        out = torch.zeros(batch + (nb1, 4), dtype=dof.dtype, device=dof.device)
        out[..., 0] = 1.0

        hid = self._hinge_ids()
        if hid.size:
            axes = self._const(self.joint_axes[hid + 1], dof)             # [H, 3]
            angles = dof[..., self.dof_offsets[hid + 1]]                   # [..., H]
            axes_b = axes.expand(batch + axes.shape)
            out[..., hid, :] = rot.axis_angle_to_quat(axes_b, angles)

        sid = self._spherical_ids()
        if sid.size:
            cols = self.dof_offsets[sid + 1][:, None] + np.arange(3)[None]  # [S, 3]
            out[..., sid, :] = rot.exp_map_to_quat(dof[..., cols])
        return out

    def rot_to_dof(self, joint_rot):
        """Inverse of dof_to_rot: [..., nb-1, 4] -> [..., dof_size]."""
        batch = joint_rot.shape[:-2]
        dof = torch.zeros(batch + (self.dof_size,), dtype=joint_rot.dtype,
                          device=joint_rot.device)

        hid = self._hinge_ids()
        if hid.size:
            axes = self._const(self.joint_axes[hid + 1], joint_rot)
            q = joint_rot[..., hid, :]
            axes_b = axes.expand(q.shape[:-1] + (3,))
            dof[..., self.dof_offsets[hid + 1]] = rot.quat_twist_angle(q, axes_b)

        sid = self._spherical_ids()
        if sid.size:
            em = rot.quat_to_exp_map(joint_rot[..., sid, :])               # [..., S, 3]
            cols = self.dof_offsets[sid + 1][:, None] + np.arange(3)[None]
            dof[..., cols] = em
        return dof

    def compute_dof_vel(self, joint_rot0, joint_rot1, dt):
        """Finite-difference dof velocities."""
        drot = rot.quat_mul(rot.quat_conjugate(joint_rot0), joint_rot1)
        drot = rot.quat_normalize(drot)
        vel_exp = rot.quat_to_exp_map(drot) / dt          # [..., nb-1, 3]
        batch = joint_rot0.shape[:-2]
        dof_vel = torch.zeros(batch + (self.dof_size,), dtype=joint_rot0.dtype,
                              device=joint_rot0.device)

        hid = self._hinge_ids()
        if hid.size:
            axes = self._const(self.joint_axes[hid + 1], joint_rot0)
            v = torch.sum(axes * vel_exp[..., hid, :], dim=-1)
            dof_vel[..., self.dof_offsets[hid + 1]] = v

        sid = self._spherical_ids()
        if sid.size:
            cols = self.dof_offsets[sid + 1][:, None] + np.arange(3)[None]
            dof_vel[..., cols] = vel_exp[..., sid, :]
        return dof_vel

    def compute_frame_dof_vel(self, joint_rot, dt):
        """Per-frame dof velocities along axis 0, last frame repeated."""
        dof_vel = self.compute_dof_vel(joint_rot[:-1], joint_rot[1:], dt)
        return torch.cat([dof_vel, dof_vel[-1:]], dim=0)

    def forward_kinematics(self, root_pos, root_rot, joint_rot):
        """Batched FK: world position and orientation of every body, on
        the inputs' device.

        Args:
          root_pos:  [..., 3] world root position.
          root_rot:  [..., 4] wxyz world root orientation.
          joint_rot: [..., nb-1, 4] local joint rotations (from dof_to_rot).

        Returns:
          body_pos [..., nb, 3], body_rot [..., nb, 4] (wxyz).
        """
        local_t = self._const(self.local_translation, root_pos)
        local_q = self._const(self.local_rotation_wxyz(), root_pos)

        pos = [root_pos]
        quat = [root_rot]
        for j in range(1, self.num_bodies):
            p = int(self.parent_indices[j])
            body_q = rot.quat_mul(local_q[j], joint_rot[..., j - 1, :])
            pos.append(pos[p] + rot.quat_rotate(quat[p], local_t[j]))
            quat.append(rot.quat_mul(quat[p], body_q))
        return torch.stack(pos, dim=-2), torch.stack(quat, dim=-2)

    # ------------------------------------------------------------- MJCF export

    def export_mjcf(self, output_file: str) -> None:
        """Write the skeleton as a standalone MJCF file: the body tree with
        hinge joints (a spherical joint expands to three orthogonal hinges)
        and a capsule geom toward each child body; it loads back through
        :func:`load_char_model` with the same BFS structure."""
        children: dict = {i: [] for i in range(self.num_bodies)}
        for i in range(1, self.num_bodies):
            children[int(self.parent_indices[i])].append(i)

        def geom_xml(i: int, indent: str) -> str:
            parts = []
            for c in children[i]:
                t = self.local_translation[c]
                if float(np.linalg.norm(t)) < 1e-6:
                    continue
                parts.append(
                    f'{indent}<geom type="capsule" fromto="0 0 0 '
                    f'{t[0]:.4f} {t[1]:.4f} {t[2]:.4f}" size="0.02" '
                    f'contype="0" conaffinity="0"/>'
                )
            if not parts:
                parts.append(
                    f'{indent}<geom type="sphere" size="0.02" contype="0" '
                    f'conaffinity="0"/>'
                )
            return "\n".join(parts)

        def joint_xml(i: int, indent: str) -> str:
            jt = JointType(int(self.joint_types[i]))
            name = self.joint_names[i]
            if jt == JointType.HINGE:
                ax = self.joint_axes[i]
                return (
                    f'{indent}<joint name="{name}" type="hinge" '
                    f'axis="{ax[0]:.4f} {ax[1]:.4f} {ax[2]:.4f}" '
                    f'range="-3.14 3.14"/>'
                )
            if jt == JointType.SPHERICAL:
                return "\n".join(
                    f'{indent}<joint name="{name}_{suffix}" type="hinge" '
                    f'axis="{ax}" range="-3.14 3.14"/>'
                    for suffix, ax in (("x", "1 0 0"), ("y", "0 1 0"), ("z", "0 0 1"))
                )
            return ""  # ROOT (free) / FIXED

        def body_xml(i: int, depth: int) -> str:
            ind = "    " * depth
            t = self.local_translation[i]
            qx = self.local_rotation[i]  # xyzw
            quat = f"{qx[3]:.6f} {qx[0]:.6f} {qx[1]:.6f} {qx[2]:.6f}"
            lines = [
                f'{ind}<body name="{self.body_names[i]}" '
                f'pos="{t[0]:.4f} {t[1]:.4f} {t[2]:.4f}" quat="{quat}">'
            ]
            inner = "    " * (depth + 1)
            if i == 0:
                lines.append(f'{inner}<freejoint name="root"/>')
            j = joint_xml(i, inner)
            if j:
                lines.append(j)
            lines.append(
                f'{inner}<inertial pos="0 0 0" mass="1.0" '
                f'diaginertia="0.01 0.01 0.01"/>'
            )
            lines.append(geom_xml(i, inner))
            for c in children[i]:
                lines.append(body_xml(c, depth + 1))
            lines.append(f"{ind}</body>")
            return "\n".join(lines)

        xml = (
            '<mujoco model="character">\n  <worldbody>\n'
            + body_xml(0, 2)
            + "\n  </worldbody>\n</mujoco>\n"
        )
        with open(output_file, "w") as f:
            f.write(xml)


# -------------------------------------------------------------------- parse


def _parse_vec(node, attr, default):
    data = node.attrib.get(attr)
    if data is None:
        return np.asarray(default, dtype=np.float64)
    return np.array(data.split(), dtype=np.float64)


def load_char_model(char_file: str) -> CharModel:
    """Parse an MJCF file into a CharModel via BFS traversal."""
    tree = ET.parse(char_file)
    root_el = tree.getroot()
    world = root_el.find("worldbody")
    if world is None:
        raise ValueError("MJCF missing <worldbody>")
    body_root = world.find("body")
    if body_root is None:
        raise ValueError("MJCF missing root <body>")

    body_names, parents, local_t, local_q = [], [], [], []
    joint_names, joint_types, joint_axes = [], [], []

    queue = [(body_root, -1, True)]
    while queue:
        node, parent, is_root = queue.pop(0)
        name = node.attrib.get("name")
        pos = _parse_vec(node, "pos", [0.0, 0.0, 0.0])
        quat_wxyz = _parse_vec(node, "quat", [1.0, 0.0, 0.0, 0.0])
        quat_xyzw = np.concatenate([quat_wxyz[1:], quat_wxyz[:1]])

        joints = node.findall("joint")
        if is_root:
            jname, jtype, jaxis = "root", JointType.ROOT, np.zeros(3)
        elif len(joints) == 0:
            jname, jtype, jaxis = name, JointType.FIXED, np.zeros(3)
        elif len(joints) == 1:
            j = joints[0]
            jt = j.attrib.get("type", "hinge")
            if jt != "hinge":
                raise ValueError(f"Unsupported joint type: {jt}")
            if np.any(_parse_vec(j, "pos", [0, 0, 0])):
                raise ValueError("Joint offsets are not supported")
            jname = j.attrib.get("name")
            jtype = JointType.HINGE
            jaxis = _parse_vec(j, "axis", [0, 0, 1])
        elif len(joints) == 3:
            base = joints[0].attrib.get("name")
            jname = base[: base.rfind("_")]
            jtype, jaxis = JointType.SPHERICAL, np.zeros(3)
        else:
            raise ValueError("Series joints are not supported")

        idx = len(body_names)
        body_names.append(name)
        parents.append(parent)
        local_t.append(pos)
        local_q.append(quat_xyzw)
        joint_names.append(jname)
        joint_types.append(int(jtype))
        joint_axes.append(jaxis)

        for child in node.findall("body"):
            queue.append((child, idx, False))

    joint_types = np.asarray(joint_types, dtype=np.int32)
    dof_offsets = np.zeros(len(body_names), dtype=np.int32)
    dof_idx = 0
    for j, jt in enumerate(joint_types):
        dof_offsets[j] = dof_idx
        dof_idx += _DOF_DIMS[JointType(int(jt))]

    return CharModel(
        body_names=body_names,
        parent_indices=np.asarray(parents, dtype=np.int32),
        local_translation=np.asarray(local_t, dtype=np.float32),
        local_rotation=np.asarray(local_q, dtype=np.float32),
        joint_names=joint_names,
        joint_types=joint_types,
        joint_axes=np.asarray(joint_axes, dtype=np.float32),
        dof_offsets=dof_offsets,
        dof_size=dof_idx,
        _name_to_idx={n: i for i, n in enumerate(body_names)},
    )
