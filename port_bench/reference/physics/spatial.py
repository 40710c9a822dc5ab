"""Minimal spatial (6D) vector algebra for batched rigid-body dynamics.

Counterpart of ``add_gym_tpu/physics/spatial.py``.  Spatial vectors are
``[..., 6]`` with the **angular part first** (Featherstone convention):
motion v = [w; v], force f = [n; f].  Spatial transforms are represented
explicitly as (R, p): rotation matrix ``[..., 3, 3]`` mapping *from parent
to child* coordinates and the child frame origin expressed in parent
coordinates.

:func:`index_sum` is the reference-layout engine's scatter-add over a
static index (contact points, sphere pairs, narrowphase contacts onto
their bodies), summed in a fixed order so that it gives the same bits on
every run of a CUDA device.  :func:`device_const` keeps the static host
tables of a model on the device, so that a step copies none of them (a
copy from pageable host memory waits for the device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_CONSTS: dict = {}


def device_const(owner, name: str, make, like, dtype=None):
    """``make()`` (a host array computed from the static ``owner``: a
    physics model or a pair table) as a tensor on ``like``'s device, of
    ``dtype`` or ``like``'s dtype, built once per (owner, name, device,
    dtype).  ``name`` names everything ``make`` depends on besides
    ``owner``.  The cache holds ``owner``, so its id stays its own."""
    dtype = dtype or like.dtype
    key = (id(owner), name, like.device, dtype)
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not owner:
        hit = (owner, torch.as_tensor(np.asarray(make()), dtype=dtype, device=like.device))
        _CONSTS[key] = hit
    return hit[1]


def cross3(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def ang(v):
    return v[..., 0:3]


def lin(v):
    return v[..., 3:6]


def sv(w, v):
    """Build a spatial vector from angular and linear parts."""
    return torch.cat([w, v], dim=-1)


def crm(v, m):
    """Spatial motion cross product  v x m  (both motion vectors)."""
    w, vl = ang(v), lin(v)
    mw, mv = ang(m), lin(m)
    return sv(cross3(w, mw), cross3(w, mv) + cross3(vl, mw))


def crf(v, f):
    """Spatial force cross product  v x* f  (motion x force)."""
    w, vl = ang(v), lin(v)
    n, fl = ang(f), lin(f)
    return sv(cross3(w, n) + cross3(vl, fl), cross3(w, fl))


def xform_motion(R, p, v):
    """Transform a motion vector from parent coords to child coords.

    X v = [R w; R (v - p x w)]  with R: parent->child, p: child origin in parent.
    """
    w, vl = ang(v), lin(v)
    Rw = torch.einsum("...ij,...j->...i", R, w)
    Rv = torch.einsum("...ij,...j->...i", R, vl - cross3(p, w))
    return sv(Rw, Rv)


def inv_xform_force(R, p, f):
    """Transform a force vector from child coords back to parent coords.

    X^T f: n_p = R^T n + p x (R^T f); f_p = R^T f.
    """
    n, fl = ang(f), lin(f)
    Rtn = torch.einsum("...ji,...j->...i", R, n)
    Rtf = torch.einsum("...ji,...j->...i", R, fl)
    return sv(Rtn + cross3(p, Rtf), Rtf)


def spatial_inertia(mass, com, inertia_com):
    """Spatial inertia (6x6) about the body frame origin.

    I = [ Ic + m cx cx^T,  m cx ;  m cx^T, m 1 ]
    with cx the skew matrix of the COM offset.  Shapes: mass [...,],
    com [..., 3], inertia_com [..., 3, 3] (about COM, body axes).
    """
    cx = skew(com)
    m = mass[..., None, None]
    top_left = inertia_com + m * cx @ cx.transpose(-1, -2)
    top_right = m * cx
    bottom_left = m * cx.transpose(-1, -2)
    eye = torch.eye(3, dtype=mass.dtype, device=mass.device).expand(cx.shape)
    bottom_right = m * eye
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def skew(v):
    """Skew-symmetric matrix [..., 3, 3] such that skew(a) @ b = a x b."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def xform_inertia(R, p, I_child):
    """Transform an articulated 6x6 inertia from child coords to parent coords.

    I_p = X^T I_c X, where X = [[R, 0], [-R px, R]] maps parent->child motion
    (px = skew(p)).  Built explicitly as a 6x6 to use one batched matmul.
    """
    px = skew(p)
    Rpx = -R @ px
    zeros = torch.zeros_like(R)
    X_top = torch.cat([R, zeros], dim=-1)
    X_bot = torch.cat([Rpx, R], dim=-1)
    X = torch.cat([X_top, X_bot], dim=-2)
    return X.transpose(-1, -2) @ I_child @ X


@functools.lru_cache(maxsize=64)
def _groups(index_bytes: bytes, device: torch.device):
    """The stable sort of a static index, its distinct targets and their
    counts; the sort and the targets on ``device``."""
    index = np.frombuffer(index_bytes, np.int64)
    order = np.argsort(index, kind="stable")
    targets, counts = np.unique(index[order], return_counts=True)
    return (torch.as_tensor(order, device=device), torch.as_tensor(targets, device=device),
            counts.tolist())


def index_sum(values, index, size: int):
    """``out[:, j] = sum of values[:, k] over index[k] == j`` for ``values``
    [N, K, ...] and a static host ``index`` [K]: ``[N, size, ...]``.

    The counterpart of JAX's ``zeros.at[:, index].add(values)``.  Entries
    are grouped by target (a stable sort, made once per index) and each
    group is reduced by one sum, so the order of the additions is fixed:
    unlike ``index_add_``, which adds with atomics on a CUDA device, two
    calls on the same inputs give the same bits.
    """
    index = np.ascontiguousarray(index, np.int64).reshape(-1)
    out = values.new_zeros((values.shape[0], size) + values.shape[2:])
    if index.size == 0:
        return out
    order, targets, counts = _groups(index.tobytes(), values.device)
    grouped = values[:, order]
    sums = [g.sum(1) for g in grouped.split(counts, dim=1)]
    out[:, targets] = torch.stack(sums, dim=1)
    return out
