"""Physics control step in env-minor stacked layout, in plain torch.

Counterpart of ``add_gym_tpu/physics/fused_step.py`` and the plain version
of the CUDA kernel in ``physics/cuda_step.py``: the same PD control,
ground contacts, held self-collision, implicit-damping articulated-body
algorithm (ABA) and semi-implicit Euler, on tensors of any device.

Every per-env quantity carries the env axis N **last**: rotations are
``[3, 3, N]``, vectors ``[3, N]``, dof quantities ``[nd, N]``.  Per-body
quantities stack on a leading body axis where the math is independent per
body (pass 1 of the ABA, the contact points); FK and ABA passes 2 and 3
walk the bodies in BFS order, relying on ``parent[i] < i`` and on body
``i`` owning dof ``i - 1``.

Per-env parameters (domain randomization) enter as ``kp``/``kv``
``[nd, N]``, ``mu`` ``[N]`` and the mass scale ``ms`` ``[N]``; ``ms``
multiplies the contact and held self-collision forces (after their sum),
the articulated-inertia blocks and the bias forces, as in the JAX
package's ``_substep_core``.

A model with narrowphase tables (``model.attach_geoms``) adds held
per-body wrenches from :func:`compute_np_ext` to the held self-collision
ones, once per control step on the pre-step state: the plain version of
the CUDA kernel's narrowphase input rows.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from add_gym_torch.physics.engine import (
    EngineParams, SimState, _body_world_velocities, apply_pd_target, forward_kinematics,
    mass_scale_or_none, narrowphase_f_ext,
)
from add_gym_torch.physics.model import PhysicsModel
from add_gym_torch.physics.narrowphase import touched_bodies
from add_gym_torch.physics.spatial import device_const

# --------------------------------------------------------------------------
# stacked helpers over [..., 3, N] vectors and [..., 3, 3, N] matrices


def m33_mul(A, B):
    """[..., 3, 3, N] @ [..., 3, 3, N] -> [..., 3, 3, N]."""
    return (A[..., :, :, None, :] * B[..., None, :, :, :]).sum(-3)


def m33_vec(A, v):
    """[..., 3, 3, N] @ [..., 3, N] -> [..., 3, N]."""
    return (A * v[..., None, :, :]).sum(-2)


def m33_T_vec(A, v):
    """[..., 3, 3, N]^T @ [..., 3, N] -> [..., 3, N]."""
    return (A * v[..., :, None, :]).sum(-3)


def m33_T(A):
    return A.transpose(-3, -2)


def vcross(a, b):
    """[..., 3, N] x [..., 3, N] -> [..., 3, N]."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-2)


def vdot(a, b):
    """[..., 3, N] . [..., 3, N] -> [..., N]."""
    return (a * b).sum(-2)


def _const_skew(r):
    return np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])


def _quat_to_mat_T(q):
    """wxyz quat [4, N] -> rotation [3, 3, N]."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n
    return torch.stack(
        [
            torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)]),
            torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)]),
            torch.stack([s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)]),
        ]
    )


def _quat_mat(q):
    w, x, y, z = q
    s = 2.0 / (q * q).sum()
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


# --------------------------------------------------------------------------


class FusedModelConstants:
    """Per-model constants precomputed on the host for the control step.

    Host arrays are float64, as in the JAX package; :meth:`tensors` hands
    out their float32 copies on a device (cached per device).
    """

    def __init__(self, model: PhysicsModel):
        self.model = model
        nb = model.nb
        self.nb = nb
        self.nd = model.nd
        self.parent = np.asarray(model.parent)

        lq = np.asarray(model.local_quat, np.float64)
        self.L = np.stack([_quat_mat(lq[i]) for i in range(nb)])
        self.r = np.asarray(model.local_pos, np.float64)

        # joint rotation M_i(c, s) = C0 + c*C1 + s*C2 (Rodrigues affine form)
        axes = np.asarray(model.joint_axis, np.float64)
        K = np.stack([_const_skew(a) for a in axes])
        KK = K @ K
        self.C0 = self.L @ (np.eye(3) + KK)
        self.C1 = self.L @ (-KK)
        self.C2 = self.L @ K
        self.axis = axes

        # spatial inertia blocks about the body origin
        mass = np.asarray(model.mass, np.float64)
        com = np.asarray(model.com, np.float64)
        inertia = np.asarray(model.inertia, np.float64)
        cx = np.stack([_const_skew(c) for c in com])
        self.IA_A = inertia + mass[:, None, None] * (cx @ np.swapaxes(cx, 1, 2))
        self.IA_B = mass[:, None, None] * cx
        self.IA_D = mass[:, None, None] * np.eye(3)[None]
        self.mass = mass

        self.armature = np.asarray(model.dof_armature, np.float64)
        self.damping = np.asarray(model.dof_damping, np.float64)
        self.friction = np.asarray(model.dof_friction, np.float64)
        self.lo = np.asarray(model.dof_limit[:, 0], np.float64)
        self.hi = np.asarray(model.dof_limit[:, 1], np.float64)

        self.cp_body = np.asarray(model.cp_body, np.int32)
        if np.any(np.diff(self.cp_body) < 0):
            raise ValueError("contact points must be grouped by body in order")
        self.cp_pos = np.asarray(model.cp_pos, np.float64)
        self.cp_radius = np.asarray(model.cp_radius, np.float64)
        self.cp_mass = np.asarray(model.cp_mass, np.float64)
        self.cp_mass_local = np.asarray(model.cp_mass_local, np.float64)
        self.cp_mass_stab = np.asarray(model.cp_mass_stab, np.float64)
        self.cp_explicit = np.asarray(model.cp_explicit)

        self.sc_body = np.asarray(model.sc_body, np.int32)
        self.sc_pos = np.asarray(model.sc_pos, np.float64).reshape(-1, 3)
        self.sc_radius = np.asarray(model.sc_radius, np.float64)
        self.sc_pairs = np.asarray(model.sc_pairs, np.int32).reshape(-1, 2)
        self.sc_stiff_mass = np.asarray(model.sc_stiff_mass, np.float64)
        # bodies with held narrowphase wrenches (sorted; empty without
        # capsule or geom tables)
        self.np_bodies = touched_bodies(model.capsules, model.geoms)
        self._dev = {}

    def contact_gains(self, params: EngineParams, dt: float):
        """Per-point spring/damper/stick-mass constants [P] (host numpy f32).

        Explicit (designed load-bearing) points keep the load-scaled
        stiffness; auto points are capped by the rotation-aware stability
        mass.
        """
        omega_n = 2.0 / params.contact_timeconst
        k = self.cp_mass * omega_n * omega_n
        b = 2.0 * params.contact_dampratio * self.cp_mass * omega_n
        k_cap = np.where(self.cp_explicit, np.inf, 0.25 * self.cp_mass_stab / (dt * dt))
        b_cap = np.where(
            self.cp_explicit, self.cp_mass_local / dt, 0.5 * self.cp_mass_stab / dt
        )
        k = np.minimum(k, k_cap)
        b = np.minimum(b, b_cap)
        stick_m = np.where(self.cp_explicit, self.cp_mass_local, self.cp_mass_stab)
        return (
            k.astype(np.float32),
            b.astype(np.float32),
            stick_m.astype(np.float32),
        )

    def sc_gains(self, params: EngineParams, dt: float):
        """Per-pair self-collision spring/damper rates [Q] (host float64)."""
        omega_sc = 2.0 / params.contact_timeconst
        m = self.sc_stiff_mass
        k_sc = np.minimum(m * omega_sc * omega_sc, 0.25 * m / (dt * dt))
        b_sc = np.minimum(2.0 * m * omega_sc, 0.5 * m / dt)
        return k_sc, b_sc

    def tensors(self, device) -> dict:
        """float32 constants on ``device``, shaped to broadcast over N."""
        device = torch.device(device)
        if device not in self._dev:
            f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
            self._dev[device] = dict(
                C0=f(self.C0)[..., None], C1=f(self.C1)[..., None],
                C2=f(self.C2)[..., None],
                r=f(self.r)[..., None], axis=f(self.axis)[..., None],
                rx=f(np.stack([_const_skew(r) for r in self.r]))[..., None],
                IA_A=f(self.IA_A)[..., None], IA_B=f(self.IA_B)[..., None],
                IA_D=f(self.IA_D)[..., None], mass=f(self.mass)[:, None, None],
                armature=f(self.armature)[:, None], damping=f(self.damping)[:, None],
                friction=f(self.friction)[:, None],
                lo=f(self.lo)[:, None], hi=f(self.hi)[:, None],
                cp_pos=f(self.cp_pos)[..., None],
                cp_radius=f(self.cp_radius)[:, None],
                cp_body=torch.as_tensor(self.cp_body, dtype=torch.long, device=device),
                sc_pos=f(self.sc_pos)[..., None],
                sc_body=torch.as_tensor(self.sc_body, dtype=torch.long, device=device),
            )
        return self._dev[device]

    def gain_tensors(self, params: EngineParams, dt: float, device) -> dict:
        """Contact and self-collision rates on ``device`` (cached per params)."""
        device = torch.device(device)
        key = ("gains", params.contact_timeconst, params.contact_dampratio, dt, device)
        if key not in self._dev:
            k, b, stick = self.contact_gains(params, dt)
            k_sc, b_sc = self.sc_gains(params, dt)
            f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
            self._dev[key] = dict(
                cp_k=f(k)[:, None], cp_b=f(b)[:, None], cp_stick=f(stick)[:, None],
                sc_k=f(k_sc)[:, None], sc_b=f(b_sc)[:, None],
                sc_rsum=f(self.sc_radius[self.sc_pairs[:, 0]]
                          + self.sc_radius[self.sc_pairs[:, 1]])[:, None],
            )
        return self._dev[key]


def _quat_update_stacked(root_quat, new_ang, dt):
    """q' = normalize(exp(dt * w) * q) in stacked [4,N]/[3,N] layout."""
    ex, ey, ez = dt * new_ang[0], dt * new_ang[1], dt * new_ang[2]
    angle = torch.sqrt(ex * ex + ey * ey + ez * ez)
    inv = 1.0 / torch.clamp_min(angle, 1e-8)
    small = angle <= 1e-5
    zero = torch.zeros_like(angle)
    half = 0.5 * torch.where(small, zero, angle)
    s = torch.sin(half) * inv
    dw = torch.cos(half)
    dx = torch.where(small, zero, ex * s)
    dy = torch.where(small, zero, ey * s)
    dz = torch.where(small, zero, ez * s)

    w2, x2, y2, z2 = root_quat
    w = dw * w2 - dx * x2 - dy * y2 - dz * z2
    x = dw * x2 + dx * w2 + dy * z2 - dz * y2
    y = dw * y2 - dx * z2 + dy * w2 + dz * x2
    z = dw * z2 + dx * y2 - dy * x2 + dz * w2
    sign = torch.where(w < 0, -1.0, 1.0)
    n = 1.0 / torch.sqrt(torch.clamp_min(w * w + x * x + y * y + z * z, 1e-12))
    return torch.stack([w * sign * n, x * sign * n, y * sign * n, z * sign * n])


def _fk_stacked(fc, root_pos, root_quat, root_vel, root_ang, qd, cos, sin):
    """Stacked forward kinematics + velocity propagation.

    Returns per-body stacks: W [nb,3,3,N] body->world rotations, o [nb,3,N]
    world origins, omega/vel [nb,3,N] world angular / origin linear
    velocities, M [nb,3,3,N] parent->body joint rotations (identity for
    the root).
    """
    t = fc.tensors(root_pos.device)
    nb = fc.nb
    # all joint rotations at once: M_i = C0 + c C1 + s C2 (body i, dof i-1)
    Mj = t["C0"][1:] + cos[:, None, None, :] * t["C1"][1:] + sin[:, None, None, :] * t["C2"][1:]
    W = [_quat_to_mat_T(root_quat)] + [None] * (nb - 1)
    o = [root_pos] + [None] * (nb - 1)
    omega = [root_ang] + [None] * (nb - 1)
    vel = [root_vel] + [None] * (nb - 1)
    r, axis = t["r"], t["axis"]
    for i in range(1, nb):
        p = int(fc.parent[i])
        W[i] = m33_mul(W[p], Mj[i - 1])
        r_w = m33_vec(W[p], r[i])
        o[i] = o[p] + r_w
        ax_w = m33_vec(W[i], axis[i])
        omega[i] = omega[p] + ax_w * qd[i - 1][None, :]
        vel[i] = vel[p] + vcross(omega[p], r_w)
    eye = torch.eye(3, dtype=cos.dtype, device=cos.device)[..., None].expand(3, 3, cos.shape[-1])
    M = torch.cat([eye[None], Mj], dim=0)
    return torch.stack(W), torch.stack(o), torch.stack(omega), torch.stack(vel), M


def _sc_forces_stacked(fc: FusedModelConstants, params: EngineParams, dt, W, o, omega, vel):
    """Self-collision penalty forces on stacked FK results.

    Returns (n [nb,3,N], f [nb,3,N]) world torque/force per body, summed
    over the model's sphere pairs in pair order.
    """
    t = fc.tensors(o.device)
    g = fc.gain_tensors(params, dt, o.device)
    sb = t["sc_body"]
    r_sp = m33_vec(W[sb], t["sc_pos"])                     # [S, 3, N]
    x_sp = o[sb] + r_sp
    v_sp = vel[sb] + vcross(omega[sb], r_sp)
    pa = torch.as_tensor(fc.sc_pairs[:, 0], dtype=torch.long, device=o.device)
    pb = torch.as_tensor(fc.sc_pairs[:, 1], dtype=torch.long, device=o.device)

    d = x_sp[pa] - x_sp[pb]                                # [Q, 3, N]
    dist = torch.sqrt(vdot(d, d) + 1e-12)                  # [Q, N]
    pen = g["sc_rsum"] - dist
    active = (pen > 0.0).to(o.dtype)
    n_dir = d / dist[:, None]
    vn = vdot(v_sp[pa] - v_sp[pb], n_dir)
    fmag = torch.clamp_min(g["sc_k"] * pen - g["sc_b"] * vn, 0.0) * active
    f_sc = n_dir * fmag[:, None]                           # [Q, 3, N]

    nb = fc.nb
    n_out = torch.zeros((nb,) + o.shape[1:], dtype=o.dtype, device=o.device)
    f_out = torch.zeros_like(n_out)
    # per pair: body a gets (+torque, +force), body b the opposite
    ba, bb = sb[pa], sb[pb]
    n_out.index_add_(0, ba, vcross(r_sp[pa], f_sc))
    f_out.index_add_(0, ba, f_sc)
    n_out.index_add_(0, bb, -vcross(r_sp[pb], f_sc))
    f_out.index_add_(0, bb, -f_sc)
    return n_out, f_out


def _substep_core(
    fc: FusedModelConstants,
    params: EngineParams,
    kp,          # [nd, 1] or [nd, N]
    kv,          # [nd, 1] or [nd, N]
    mu,          # float or [N]
    dt,
    root_pos,    # [3, N]
    root_quat,   # [4, N]
    root_vel,    # [3, N]
    root_ang,    # [3, N]
    q,           # [nd, N]
    qd,          # [nd, N]
    tgt,         # [nd, N]
    sc_ext=None,  # (n [nb,3,N], f [nb,3,N]) held self-collision + narrowphase forces
    ms=None,      # [N] per-env mass/inertia scale (None = 1)
):
    """One physics substep on stacked env-minor tensors.

    Returns (root_pos, root_quat, root_vel, root_ang, q, qd, contact [nb, N]).
    """
    t = fc.tensors(root_pos.device)
    g = fc.gain_tensors(params, dt, root_pos.device)
    nb = fc.nb
    nd = fc.nd
    N = root_pos.shape[-1]
    f32 = root_pos.dtype

    cos = torch.cos(q)
    sin = torch.sin(q)

    # ---------------------------------------------------------- FK + vel
    W, o, omega, vel, M = _fk_stacked(
        fc, root_pos, root_quat, root_vel, root_ang, qd, cos, sin
    )

    # ---------------------------------------------------------- contacts
    cb = t["cp_body"]
    Wc = W[cb]                                             # [P, 3, 3, N]
    rp = m33_vec(Wc, t["cp_pos"])                          # [P, 3, N]
    x_z = o[cb][:, 2] + rp[:, 2]
    v_pt = vel[cb] + vcross(omega[cb], rp)                 # [P, 3, N]
    phi = x_z - t["cp_radius"]
    pen = torch.clamp_min(-phi, 0.0)
    active = (phi < 0.0).to(f32)
    fn = torch.clamp_min(g["cp_k"] * pen - g["cp_b"] * v_pt[:, 2], 0.0) * active

    speed = torch.sqrt(v_pt[:, 0] ** 2 + v_pt[:, 1] ** 2 + 1e-10)
    f_t_mag = torch.minimum(mu * fn, g["cp_stick"] * speed / dt)
    scale = -f_t_mag / speed
    f_pt = torch.stack([scale * v_pt[:, 0], scale * v_pt[:, 1], fn], dim=1)
    n_pt = vcross(rp, f_pt)

    f_w = torch.zeros((nb, 3, N), dtype=f32, device=q.device)
    n_w = torch.zeros_like(f_w)
    contact = torch.zeros((nb, N), dtype=f32, device=q.device)
    f_w.index_add_(0, cb, f_pt)
    n_w.index_add_(0, cb, n_pt)
    contact.index_add_(0, cb, fn)
    if ms is not None:
        # contact springs are mass-proportional: a heavier robot presses
        # and is caught proportionally harder
        contact = contact * ms

    # ---------------------------------------------- self-collision (held)
    if sc_ext is not None:
        n_w = n_w + sc_ext[0]
        f_w = f_w + sc_ext[1]
    if ms is not None:
        # ground + self-collision forces scale with the mass, after the sum
        n_w = n_w * ms
        f_w = f_w * ms

    # ------------------------------------------------------- joint torques
    t_pd = torch.clamp(kp * (tgt - q) - kv * qd, -params.max_torque, params.max_torque)
    lo_c, hi_c = t["lo"], t["hi"]
    k_lim = 400.0
    tau = (
        t_pd
        - t["damping"] * qd
        - t["friction"] * torch.tanh(qd / 0.05)
        + k_lim * torch.clamp_min(lo_c - q, 0.0)
        - k_lim * torch.clamp_min(q - hi_c, 0.0)
    )                                                      # [nd, N]

    # ----------------------------------------------------------- ABA pass 1
    # independent per body: body-frame velocities, velocity-product
    # accelerations, bias forces minus external forces
    w_b = m33_T_vec(W, omega)                              # [nb, 3, N]
    v_b = m33_T_vec(W, vel)
    qd_b = torch.cat([torch.zeros_like(qd[:1]), qd], dim=0)  # body 0 has no dof
    wJ = t["axis"] * qd_b[:, None, :]
    c_n = vcross(w_b, wJ)
    c_f = vcross(v_b, wJ)
    IA_A, IA_B, mass = t["IA_A"], t["IA_B"], t["mass"]
    Iv_n = m33_vec(IA_A, w_b) + m33_vec(IA_B, v_b)
    Iv_f = m33_T_vec(IA_B, w_b) + mass * v_b
    bias_n = vcross(w_b, Iv_n) + vcross(v_b, Iv_f)
    bias_f = vcross(w_b, Iv_f)
    IA_D = t["IA_D"]
    if ms is not None:
        # the per-env mass scale lifts the inertia blocks and bias forces
        bias_n = bias_n * ms
        bias_f = bias_f * ms
        IA_A, IA_B, IA_D = IA_A * ms, IA_B * ms, IA_D * ms
    pA_n = list((bias_n - m33_T_vec(W, n_w)).unbind(0))
    pA_f = list((bias_f - m33_T_vec(W, f_w)).unbind(0))
    A = list(IA_A.expand(nb, 3, 3, N).unbind(0))
    B = list(IA_B.expand(nb, 3, 3, N).unbind(0))
    D = list(IA_D.expand(nb, 3, 3, N).unbind(0))

    # ----------------------------------------------------------- ABA pass 2
    U_t = [None] * nb
    U_b = [None] * nb
    d_inv = [None] * nb
    u_ = [None] * nb
    axis, r = t["axis"], t["r"]
    for i in range(nb - 1, 0, -1):
        p = int(fc.parent[i])
        di = i - 1
        ax = axis[i]                                       # [3, 1]
        Ut = m33_vec(A[i], ax)                             # [3, N]
        Ub = m33_T_vec(B[i], ax)
        d = (Ut * ax).sum(0) + t["armature"][di] + dt * (t["damping"][di] + kv[di])
        dinv = 1.0 / d
        u = tau[di] - (ax * pA_n[i]).sum(0)
        U_t[i], U_b[i], d_inv[i], u_[i] = Ut, Ub, dinv, u

        # Ia = IA - U U^T / d (blocks)
        Ap = A[i] - Ut[:, None] * Ut[None] * dinv[None, None]
        Bp = B[i] - Ut[:, None] * Ub[None] * dinv[None, None]
        Dp = D[i] - Ub[:, None] * Ub[None] * dinv[None, None]

        # pa = pA + Ia c + U (u/d)
        ud = (u * dinv)[None]
        pan = pA_n[i] + m33_vec(Ap, c_n[i]) + m33_vec(Bp, c_f[i]) + Ut * ud
        paf = pA_f[i] + m33_T_vec(Bp, c_n[i]) + m33_vec(Dp, c_f[i]) + Ub * ud

        # to parent coords: n_p = M pan + r x (M paf); f_p = M paf
        Mi = M[i]
        Mpan = m33_vec(Mi, pan)
        Mpaf = m33_vec(Mi, paf)
        pA_n[p] = pA_n[p] + Mpan + vcross(r[i], Mpaf)
        pA_f[p] = pA_f[p] + Mpaf

        # inertia: sandwich with X = [[E,0],[F,E]], E = Mi^T, F = -E r~
        MiT = m33_T(Mi)
        Ah = m33_mul(m33_mul(Mi, Ap), MiT)
        Bh = m33_mul(m33_mul(Mi, Bp), MiT)
        Dh = m33_mul(m33_mul(Mi, Dp), MiT)
        rx = t["rx"][i]
        Bh_rx = m33_mul(Bh, rx)
        rx_Dh = m33_mul(rx, Dh)
        rx_Dh_rx = m33_mul(rx_Dh, rx)

        A[p] = A[p] + (Ah - Bh_rx - m33_T(Bh_rx) - rx_Dh_rx)
        B[p] = B[p] + (Bh + rx_Dh)
        D[p] = D[p] + Dh

    # ----------------------------------------------------------- ABA pass 3
    a0 = _solve6(A[0], B[0], D[0], -torch.cat([pA_n[0], pA_f[0]], dim=0))
    a_n = [a0[0:3]] + [None] * (nb - 1)
    a_f = [a0[3:6]] + [None] * (nb - 1)
    qdd_rows = [None] * nd
    for i in range(1, nb):
        p = int(fc.parent[i])
        Mi = M[i]
        # X a_p: w' = Mi^T w ; v' = Mi^T (v - r x w)
        w_l = m33_T_vec(Mi, a_n[p]) + c_n[i]
        v_l = m33_T_vec(Mi, a_f[p] - vcross(r[i], a_n[p])) + c_f[i]
        qdd_i = (u_[i] - (vdot(U_t[i], w_l) + vdot(U_b[i], v_l))) * d_inv[i]
        qdd_rows[i - 1] = qdd_i
        a_n[i] = w_l + axis[i] * qdd_i[None]
        a_f[i] = v_l
    qdd = torch.stack(qdd_rows)                            # [nd, N]

    # ------------------------------------------------------- integration
    W0 = W[0]
    wdot_w = m33_vec(W0, a_n[0])
    a_lin = m33_vec(W0, a_f[0]) + vcross(root_ang, root_vel)
    a_lin_w = torch.stack([a_lin[0], a_lin[1], a_lin[2] - params.gravity])

    vmax = 100.0
    new_ang = torch.clamp(root_ang + dt * wdot_w, -vmax, vmax)
    new_vel = torch.clamp(root_vel + dt * a_lin_w, -vmax, vmax)
    new_pos = root_pos + dt * new_vel
    new_quat = _quat_update_stacked(root_quat, new_ang, dt)

    new_qd = torch.clamp(qd + dt * qdd, -vmax, vmax)
    new_q = q + dt * new_qd
    zero = torch.zeros_like(new_qd)
    new_qd = torch.where((new_q > hi_c) & (new_qd > 0), zero, new_qd)
    new_qd = torch.where((new_q < lo_c) & (new_qd < 0), zero, new_qd)
    new_q = torch.minimum(torch.maximum(new_q, lo_c), hi_c)

    return new_pos, new_quat, new_vel, new_ang, new_q, new_qd, contact


def _solve6(A, B, D, rhs):
    """Solve [[A,B],[B^T,D]] x = rhs, blocks [3,3,N], rhs [6,N].

    Unrolled Cholesky with the pivot clamped at 1e-9.
    """
    top = torch.cat([A, B], dim=1)
    bot = torch.cat([m33_T(B), D], dim=1)
    Mf = torch.cat([top, bot], dim=0)                      # [6, 6, N]

    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        ssum = Mf[j, j]
        for k in range(j):
            ssum = ssum - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(ssum, 1e-9))
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, 6):
            ssum = Mf[i, j]
            for k in range(j):
                ssum = ssum - L[i][k] * L[j][k]
            L[i][j] = ssum * inv_ljj

    y = [None] * 6
    for i in range(6):
        ssum = rhs[i]
        for k in range(i):
            ssum = ssum - L[i][k] * y[k]
        y[i] = ssum / L[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        ssum = y[i]
        for k in range(i + 1, 6):
            ssum = ssum - L[k][i] * x[k]
        x[i] = ssum / L[i][i]
    return torch.stack(x)                                  # [6, N]


def _prep_params(params: EngineParams, device):
    """Gains in stacked layout (``[nd, N]`` per env or ``[nd, 1]`` shared),
    friction (float or ``[N]``) and the mass scale (``[N]`` / ``[1]`` or
    None) on ``device``."""
    def gains(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return x.T if x.ndim == 2 else x[:, None]

    mu = params.friction_mu
    if isinstance(mu, torch.Tensor):
        mu = mu.to(device=device, dtype=torch.float32)
    else:
        mu = float(mu)
    ms = mass_scale_or_none(params)
    if ms is not None:
        ms = ms.to(device)
    return gains(params.kp), gains(params.kv), mu, ms


def compute_sc_ext(fc: FusedModelConstants, params: EngineParams, dt, state: SimState):
    """Held self-collision forces for a control step (or None).

    Evaluated once per control step on the pre-step state and held across
    the substeps.
    """
    if not params.self_collision or not len(fc.sc_pairs):
        return None
    q = state.dof_pos.T
    W, o, omega, vel, _ = _fk_stacked(
        fc, state.root_pos.T, state.root_quat.T, state.root_vel.T,
        state.root_ang_vel.T, state.dof_vel.T, torch.cos(q), torch.sin(q),
    )
    return _sc_forces_stacked(fc, params, dt, W, o, omega, vel)


def compute_np_ext(fc: FusedModelConstants, params: EngineParams, dt, state: SimState):
    """Held capsule/geom narrowphase wrenches for a control step (or None).

    Evaluates the reference-layout narrowphase (``engine.narrowphase_f_ext``
    over ``[N, nb]`` FK of ``state``) and returns ``{body: (n [3, N], f
    [3, N])}`` over ``fc.np_bodies``, the static sorted set of bodies any
    pair table can touch: the kernel's ``6 * len(np_bodies)`` input rows
    (:func:`np_rows`).  The per-body sums run in a fixed order
    (``spatial.index_sum``), so the result is the same bits on every run.
    """
    if not len(fc.np_bodies):
        return None
    model = fc.model
    body_pos, body_rot = forward_kinematics(model, state)
    omega_w, v_origin_w = _body_world_velocities(model, state, body_rot)
    f_ext = narrowphase_f_ext(model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
    bodies = device_const(fc, "np_bodies", lambda: fc.np_bodies, f_ext, torch.long)
    rows = f_ext[:, bodies].permute(1, 2, 0)
    return {int(b): (rows[j, 0:3], rows[j, 3:6]) for j, b in enumerate(fc.np_bodies)}


def np_rows(np_ext):
    """The held wrenches as env-minor rows [6 * n_touched, N]: per body in
    sorted order, torque rows 0-2 then force rows 3-5."""
    return torch.cat([torch.cat(np_ext[b], dim=0) for b in sorted(np_ext)], dim=0)


def merge_ext(a, b):
    """Merge two {body: (n, f)} held-force dicts (either may be None)."""
    if a is None:
        return b
    if b is None:
        return a
    out = dict(a)
    for k, (n_c, f_c) in b.items():
        if k in out:
            n0, f0 = out[k]
            out[k] = (n0 + n_c, f0 + f_c)
        else:
            out[k] = (n_c, f_c)
    return out


def _held_ext(fc: FusedModelConstants, params: EngineParams, dt, state: SimState):
    """Held self-collision plus narrowphase wrenches as stacked
    (n [nb, 3, N], f [nb, 3, N]), or None when there are neither."""
    sc_ext = compute_sc_ext(fc, params, dt, state)
    np_ext = compute_np_ext(fc, params, dt, state)
    if np_ext is None:
        return sc_ext
    # self-collision first, then narrowphase: the kernel's order of addition
    held = merge_ext(None if sc_ext is None else dict(enumerate(zip(*sc_ext))), np_ext)
    zero = state.root_pos.new_zeros((3, state.root_pos.shape[0]))
    per_body = [held.get(b, (zero, zero)) for b in range(fc.nb)]
    return torch.stack([n for n, _ in per_body]), torch.stack([f for _, f in per_body])


def fused_substep(fc: FusedModelConstants, params: EngineParams, state: SimState, dt):
    """One physics substep, stacked env-minor layout, with the held forces
    evaluated on ``state``.  Returns (state, body_contact [N, nb])."""
    kp, kv, mu, ms = _prep_params(params, state.root_pos.device)
    rp, rq, rv, ra, q, qd, contact = _substep_core(
        fc, params, kp, kv, mu, dt,
        state.root_pos.T, state.root_quat.T, state.root_vel.T, state.root_ang_vel.T,
        state.dof_pos.T, state.dof_vel.T, state.pd_target.T,
        sc_ext=_held_ext(fc, params, dt, state), ms=ms,
    )
    new_state = SimState(
        root_pos=rp.T, root_quat=rq.T, root_vel=rv.T, root_ang_vel=ra.T,
        dof_pos=q.T, dof_vel=qd.T, pd_target=state.pd_target,
    )
    return new_state, contact.T


def fused_step(fc: FusedModelConstants, params: EngineParams, state: SimState, pd_target):
    """Control step: PD clamp/slew + ``substeps`` substeps.

    Returns (state, contact [N, nb]) where contact is the last substep's
    per-body normal force.
    """
    tgt = apply_pd_target(fc.model, params, state, pd_target)
    state = replace(state, pd_target=tgt)
    dt = params.ctrl_dt / params.substeps
    kp, kv, mu, ms = _prep_params(params, state.root_pos.device)
    sc_ext = _held_ext(fc, params, dt, state)

    rp, rq, rv, ra = state.root_pos.T, state.root_quat.T, state.root_vel.T, state.root_ang_vel.T
    q, qd, tg = state.dof_pos.T, state.dof_vel.T, tgt.T
    contact = None
    for _ in range(params.substeps):
        rp, rq, rv, ra, q, qd, contact = _substep_core(
            fc, params, kp, kv, mu, dt, rp, rq, rv, ra, q, qd, tg, sc_ext=sc_ext, ms=ms,
        )
    new_state = SimState(
        root_pos=rp.T, root_quat=rq.T, root_vel=rv.T, root_ang_vel=ra.T,
        dof_pos=q.T, dof_vel=qd.T, pd_target=tgt,
    )
    return new_state, contact.T


def shard_params(params: EngineParams, shard) -> EngineParams:
    """``params`` for the envs of ``shard`` (``parallel.mesh.EnvShard``).

    The leaf rule of the JAX package's ``sharded_pallas_step``: a per-env
    leaf whose leading dim is the *global* env count (gains ``[N, nd]``,
    friction or mass scale ``[N]``) is sliced to the shard; shared leaves
    (``[nd]`` gains, scalars) and per-env leaves already of the shard's
    size pass whole.  Only the per-env ranks count (2-D gains, 1-D
    friction and mass scale), so a dof count equal to the env count cannot
    be taken for an env axis.
    """
    def leaf(x, per_env_ndim):
        if (isinstance(x, torch.Tensor) and x.ndim == per_env_ndim
                and x.shape[0] == shard.num_envs):
            return x[shard.start:shard.stop]
        return x

    return replace(params, kp=leaf(params.kp, 2), kv=leaf(params.kv, 2),
                   friction_mu=leaf(params.friction_mu, 1),
                   mass_scale=leaf(params.mass_scale, 1))


def sharded_fused_step(fc: FusedModelConstants, params: EngineParams, state: SimState,
                       pd_target, shard):
    """The plain version of ``cuda_step.sharded_cuda_step``: ``fused_step``
    on the shard's envs (``state`` and ``pd_target`` hold only those),
    with the per-env leaves of ``params`` sliced by :func:`shard_params`."""
    return fused_step(fc, shard_params(params, shard), state, pd_target)
