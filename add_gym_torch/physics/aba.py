"""Featherstone Articulated-Body Algorithm, batched over environments.

Counterpart of ``add_gym_tpu/physics/aba.py``: forward dynamics for a
floating-base rigid-body tree with hinge joints in the reference ``[N, nb,
...]`` layout (the plain ``engine.step``; the control step of the main path
runs the env-minor version in ``fused_step`` and the CUDA kernel).

- The tree loop is unrolled in Python over the bodies (static topology);
  every per-body quantity is batched ``[N, ...]``.
- Joint-space damping (joint damping + PD kv) is integrated *implicitly* by
  adding ``dt * d`` to the ABA articulated-inertia denominator.
- The free base is solved with one batched 6x6 linear solve.

All spatial quantities are expressed in each body's own frame with the
angular component first (see physics/spatial.py).
"""

from __future__ import annotations

import torch

from add_gym_torch.physics import spatial as sp


def _hinge_S(axis, batch_shape):
    """Motion subspace of a hinge about the body-frame axis: [axis; 0]."""
    a = axis.expand(batch_shape + (3,))
    return sp.sv(a, torch.zeros_like(a))


def aba(
    model,
    # kinematics (computed by the engine's FK pass), all in world frame:
    body_rot_w,      # [N, nb, 3, 3] body->world rotation
    # joint state:
    root_vel_b,      # [N, 6] root spatial velocity in root body coords
    dof_vel,         # [N, nd]
    joint_rot,       # [N, nb-1, 3, 3] per-joint rotation (body i local joint)
    tau,             # [N, nd] joint torques (active + passive explicit part)
    f_ext_w,         # [N, nb, 6] external spatial force per body, world coords
                     #            about each body's own origin
    implicit_damping,  # [N, nd] or [nd]: d added to denominator scaled by dt
    dt: float,
    gravity: float = 9.81,
    ms=None,         # [N] or [1] per-env mass/inertia scale (None = 1)
):
    """Returns (qdd [N, nd], root_acc_true [N, 6] in root body coords)."""
    nb = model.nb
    N = dof_vel.shape[0]
    f32 = dof_vel.dtype
    dev = dof_vel.device
    c = lambda x: torch.as_tensor(x, dtype=f32, device=dev)

    parent = model.parent
    local_pos = c(model.local_pos)
    local_quat_mat = _local_rot_mats(model, f32, dev)     # [nb, 3, 3]
    axes = c(model.joint_axis)
    armature = c(model.dof_armature)

    # --- per-body fixed spatial inertia [nb, 6, 6], broadcast over N
    I_body = sp.spatial_inertia(c(model.mass), c(model.com), c(model.inertia))

    # --- parent->child transforms E_i (rotation), r_i (child origin in parent)
    # E_i = (L_i @ J_i)^T ; L from MJCF local quat, J from current joint angle.
    E = [None] * nb
    for i in range(1, nb):
        E[i] = (local_quat_mat[i] @ joint_rot[:, i - 1]).transpose(-1, -2)

    # external forces to body coords (about body origin)
    Wt = body_rot_w.transpose(-1, -2)                      # world->body
    n_b = torch.einsum("nbij,nbj->nbi", Wt, f_ext_w[..., 0:3])
    f_b = torch.einsum("nbij,nbj->nbi", Wt, f_ext_w[..., 3:6])
    f_ext = torch.cat([n_b, f_b], dim=-1)                  # [N, nb, 6]

    # --- pass 1: velocities, bias, init articulated quantities
    v = [None] * nb
    cv = [None] * nb
    IA = [None] * nb
    pA = [None] * nb

    v[0] = root_vel_b
    cv[0] = torch.zeros((N, 6), dtype=f32, device=dev)
    one = torch.ones((N,), dtype=f32, device=dev) if ms is None else ms.expand(N)
    IA[0] = I_body[0] * one[:, None, None]
    pA[0] = (
        one[:, None] * sp.crf(v[0], torch.einsum("ij,nj->ni", I_body[0], v[0]))
        - f_ext[:, 0]
    )

    S = [None] * nb
    for i in range(1, nb):
        p = int(parent[i])
        vp_child = sp.xform_motion(E[i], local_pos[i], v[p])
        di = i - 1
        S[i] = _hinge_S(axes[i], (N,))
        vJ = S[i] * dof_vel[:, di, None]
        v[i] = vp_child + vJ
        cv[i] = sp.crm(v[i], vJ)
        IA[i] = I_body[i] * one[:, None, None]
        pA[i] = (
            one[:, None]
            * sp.crf(v[i], torch.einsum("ij,nj->ni", I_body[i], v[i]))
            - f_ext[:, i]
        )

    # --- pass 2: inward articulated inertia recursion
    U = [None] * nb
    d_inv = [None] * nb
    u = [None] * nb
    imp = c(implicit_damping).expand(N, model.nd)
    for i in range(nb - 1, 0, -1):
        p = int(parent[i])
        di = i - 1
        U[i] = torch.einsum("nij,nj->ni", IA[i], S[i])     # [N, 6]
        d = (
            torch.einsum("ni,ni->n", S[i], U[i])
            + armature[di]
            + dt * imp[:, di]
        )
        d_inv[i] = 1.0 / d
        u[i] = tau[:, di] - torch.einsum("ni,ni->n", S[i], pA[i])

        Ia = IA[i] - U[i][:, :, None] * U[i][:, None, :] * d_inv[i][:, None, None]
        pa = (
            pA[i]
            + torch.einsum("nij,nj->ni", Ia, cv[i])
            + U[i] * (u[i] * d_inv[i])[:, None]
        )
        IA[p] = IA[p] + sp.xform_inertia(E[i], local_pos[i], Ia)
        pA[p] = pA[p] + sp.inv_xform_force(E[i], local_pos[i], pa)

    # --- pass 3: outward accelerations
    a = [None] * nb
    # apparent acceleration of the free base (gravity handled as offset below)
    a[0] = -torch.linalg.solve(IA[0], pA[0][..., None])[..., 0]

    qdd_cols = [None] * model.nd
    for i in range(1, nb):
        p = int(parent[i])
        a_p = sp.xform_motion(E[i], local_pos[i], a[p]) + cv[i]
        qdd_i = (u[i] - torch.einsum("ni,ni->n", U[i], a_p)) * d_inv[i]
        a[i] = a_p + S[i] * qdd_i[:, None]
        qdd_cols[i - 1] = qdd_i
    qdd = torch.stack(qdd_cols, dim=1)

    # true root acceleration = apparent + gravity in root body coords
    g_w = torch.tensor([0.0, 0.0, -gravity], dtype=f32, device=dev)
    g_b = torch.einsum("nij,nj->ni", Wt[:, 0], g_w.expand(N, 3))
    zeros3 = torch.zeros((N, 3), dtype=f32, device=dev)
    root_acc_true = a[0] + torch.cat([zeros3, g_b], dim=-1)
    return qdd, root_acc_true


def _local_rot_mats(model, dtype, device=None):
    q = torch.as_tensor(model.local_quat, dtype=dtype, device=device)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = torch.sum(q * q, dim=-1)
    s = 2.0 / n
    row0 = torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)], -1)
    row1 = torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)], -1)
    row2 = torch.stack([s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)
