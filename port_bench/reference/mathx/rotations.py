"""Quaternion / rotation math on torch tensors.

Counterpart of ``add_gym_tpu/mathx/rotations.py``, function for function:
quaternions are **wxyz**, rotations are active, and every function
broadcasts over arbitrary leading batch dims.  Masked branches use
``torch.where`` so results match the JAX version element for element.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _basis(like, idx: int):
    """Unit vector along axis ``idx`` shaped like ``like`` ([..., 3])."""
    e = torch.zeros_like(like)
    e[..., idx] = 1.0
    return e


def normalize_angle(x):
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def normalize(x, eps: float = _EPS):
    """Normalize the last axis to unit length."""
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(n, eps)


def quat_unit(q):
    return normalize(q)


def quat_conjugate(q):
    return torch.cat([q[..., 0:1], -q[..., 1:]], dim=-1)


def quat_pos(q):
    """Flip quaternions into the w >= 0 hemisphere."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quat_mul(a, b):
    """Hamilton product, wxyz."""
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v by quaternions q."""
    q_w = q[..., 0:1]
    q_v = q[..., 1:]
    t = 2.0 * _cross(q_v, v)
    return v + q_w * t + _cross(q_v, t)


def quat_to_axis_angle(q):
    """Return (axis, angle) with angle in [0, pi]."""
    eps = 1e-5
    q = quat_pos(q)
    length = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(length, q[..., 0])
    axis = q[..., 1:] / torch.clamp_min(length[..., None], _EPS)

    default_axis = _basis(axis, 2)
    mask = length > eps
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, default_axis)
    return axis, angle


def quat_to_matrix(q):
    """3x3 rotation matrix."""
    w, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    mat = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * w),
            two_s * (i * k + j * w),
            two_s * (i * j + k * w),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * w),
            two_s * (i * k - j * w),
            two_s * (j * k + i * w),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return mat.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis, angle):
    theta = 0.5 * angle[..., None]
    xyz = normalize(axis) * torch.sin(theta)
    w = torch.cos(theta).expand(xyz[..., :1].shape)
    return quat_unit(torch.cat([w, xyz], dim=-1))


def quat_to_exp_map(q):
    axis, angle = quat_to_axis_angle(q)
    return angle[..., None] * axis


def exp_map_to_axis_angle(exp_map):
    min_theta = 1e-5
    angle = torch.linalg.norm(exp_map, dim=-1)
    axis = exp_map / torch.clamp_min(angle[..., None], _EPS)
    angle = normalize_angle(angle)

    default_axis = _basis(exp_map, 2)
    mask = torch.abs(angle) > min_theta
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, default_axis)
    return axis, angle


def exp_map_to_quat(exp_map):
    axis, angle = exp_map_to_axis_angle(exp_map)
    return axis_angle_to_quat(axis, angle)


def quat_diff(q0, q1):
    """dq such that dq * q0 = q1 (left difference)."""
    return quat_mul(q1, quat_conjugate(q0))


def quat_diff_angle(q0, q1):
    """Geodesic angle between two quaternions."""
    _, angle = quat_to_axis_angle(quat_diff(q0, q1))
    return angle


def quat_normalize(q):
    """Unit quaternion in the positive hemisphere."""
    return quat_unit(quat_pos(q))


def quat_to_tan_norm(q):
    """6D rotation representation: rotated x-axis ++ rotated z-axis."""
    tan = quat_rotate(q, _basis(q[..., 1:], 0))
    norm = quat_rotate(q, _basis(q[..., 1:], 2))
    return torch.cat([tan, norm], dim=-1)


def slerp(q0, q1, t):
    """Spherical interpolation; t has one fewer dim than q."""
    cos_half_theta = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where((cos_half_theta < 0)[..., None], -q1, q1)
    cos_half_theta = torch.abs(cos_half_theta)[..., None]

    half_theta = torch.acos(torch.clamp(cos_half_theta, -1.0, 1.0))
    sin_half_theta = torch.sqrt(torch.clamp_min(1.0 - cos_half_theta * cos_half_theta, 0.0))
    small = torch.abs(sin_half_theta) < 0.001
    safe_sin = torch.where(small, torch.ones_like(sin_half_theta), sin_half_theta)

    t = t[..., None]
    ratio_a = torch.sin((1.0 - t) * half_theta) / safe_sin
    ratio_b = torch.sin(t * half_theta) / safe_sin
    new_q = ratio_a * q0 + ratio_b * q1
    new_q = torch.where(small, 0.5 * q0 + 0.5 * q1, new_q)
    new_q = torch.where(torch.abs(cos_half_theta) >= 1.0, q0, new_q)
    return new_q


def calc_heading(q):
    """Yaw of the rotated x-axis."""
    rot_dir = quat_rotate(q, _basis(q[..., 1:], 0))
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat_inv(q):
    heading = calc_heading(q)
    return axis_angle_to_quat(_basis(q[..., 1:], 2), -heading)


def quat_twist(q, twist_axis):
    """Twist component of q about twist_axis."""
    p = torch.sum(twist_axis * q[..., 1:], dim=-1, keepdim=True)
    twist = torch.cat([q[..., 0:1], p * twist_axis], dim=-1)
    return quat_normalize(twist)


def quat_twist_angle(q, twist_axis):
    """Signed twist angle about twist_axis."""
    twist = quat_twist(q, twist_axis)
    axis, angle = quat_to_axis_angle(twist)
    dot_axis = torch.sum(twist_axis * axis, dim=-1)
    return torch.where(dot_axis < 0, -angle, angle)
