"""Batched physics engine in the reference layout: state, FK, contacts,
PD control and integration.

Counterpart of ``add_gym_tpu/physics/engine.py``: one ``SimState`` of
``[N, ...]`` tensors and a pure ``step(model, params, state, pd_target) ->
(state, contact)`` that runs PD control, ground contacts, held
self-collision and narrowphase wrenches, the articulated-body algorithm
(``aba.py``) and semi-implicit Euler over ``substeps`` substeps per control
step.  Per-body quantities are ``[N, nb, ...]``: the readable reference
for the env-minor plain step (``fused_step``) and the CUDA kernel
(``cuda_step``), selected with ``engine.fused: false`` and checked against
them by ``utils/debug.parity_check``.  ``forward_kinematics``,
``_body_world_velocities`` and ``narrowphase_f_ext`` also feed the held
narrowphase wrenches of the other two backends
(``fused_step.compute_np_ext``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

import add_gym_torch.mathx.rotations as rot
from add_gym_torch.physics import spatial as sp
from add_gym_torch.physics.aba import _local_rot_mats, aba
from add_gym_torch.physics.model import PhysicsModel
from add_gym_torch.physics.narrowphase import capsule_f_ext, geom_f_ext


@dataclass(frozen=True)
class SimState:
    """Batched simulation state.  All tensors lead with the env axis N.

    Root velocities are world-frame (linear velocity of the root origin and
    angular velocity).
    """

    root_pos: torch.Tensor      # [N, 3]
    root_quat: torch.Tensor     # [N, 4] wxyz
    root_vel: torch.Tensor      # [N, 3]
    root_ang_vel: torch.Tensor  # [N, 3]
    dof_pos: torch.Tensor       # [N, nd]
    dof_vel: torch.Tensor       # [N, nd]
    pd_target: torch.Tensor     # [N, nd] previous PD target (slew limiting)

    @property
    def num_envs(self):
        return self.root_pos.shape[0]


@dataclass(frozen=True)
class EngineParams:
    """Control/contact parameters.

    ``kp``/``kv`` are shared ``[nd]`` gains or per-env ``[N, nd]`` ones;
    ``friction_mu`` is a float or a per-env ``[N]`` tensor; ``mass_scale``
    (whole-body mass/inertia multiplier: spatial inertias, bias forces and
    contact forces scale with it, gravity and the actuators do not) is the
    float 1.0 or a per-env ``[N]`` tensor.  Per-env values come from
    domain randomization (``ImitationEnv._effective_params``).
    """

    kp: torch.Tensor                # [nd] or [N, nd]
    kv: torch.Tensor                # [nd] or [N, nd]
    ctrl_dt: float = 0.01
    substeps: int = 4
    max_torque: float = 200.0
    max_target_delta: float = 0.5
    position_limit_margin: float = 1e-4
    contact_timeconst: float = 0.02
    contact_dampratio: float = 1.0
    friction_mu: float | torch.Tensor = 1.0
    mass_scale: float | torch.Tensor = 1.0
    gravity: float = 9.81
    self_collision: bool = True


def mass_scale_or_none(params: EngineParams):
    """The mass scale as a float32 ``[N]`` or ``[1]`` tensor, or None for the
    float 1.0 (no scaling)."""
    ms = params.mass_scale
    if not isinstance(ms, torch.Tensor):
        if float(ms) == 1.0:
            return None
        ms = torch.tensor(float(ms))
    ms = ms.to(torch.float32)
    return ms[None] if ms.ndim == 0 else ms


def is_per_env(params: EngineParams) -> bool:
    """Whether ``params`` carry per-env leaves (domain randomization): the
    control step kernel's per-env variant takes them."""
    return (
        torch.as_tensor(params.kp).ndim == 2
        or torch.as_tensor(params.kv).ndim == 2
        or isinstance(params.friction_mu, torch.Tensor)
        or mass_scale_or_none(params) is not None
    )


def default_state(model: PhysicsModel, num_envs: int, device="cpu",
                  dtype=torch.float32) -> SimState:
    zeros = lambda *s: torch.zeros((num_envs,) + s, dtype=dtype, device=device)
    quat = zeros(4)
    quat[:, 0] = 1.0
    return SimState(
        root_pos=zeros(3),
        root_quat=quat,
        root_vel=zeros(3),
        root_ang_vel=zeros(3),
        dof_pos=zeros(model.nd),
        dof_vel=zeros(model.nd),
        pd_target=zeros(model.nd),
    )


def apply_pd_target(model: PhysicsModel, params: EngineParams, state: SimState, target):
    """Clamp targets to joint limits (with margin) and slew-limit the change."""
    lim = torch.as_tensor(model.dof_limit, dtype=target.dtype, device=target.device)
    lo = lim[:, 0] + params.position_limit_margin
    hi = lim[:, 1] - params.position_limit_margin
    tgt = torch.minimum(torch.maximum(target, lo), hi)
    delta = torch.clamp(
        tgt - state.pd_target, -params.max_target_delta, params.max_target_delta
    )
    return state.pd_target + delta


def _c(model, name: str, like, make=None, dtype=None):
    """The model's host array ``name`` (or ``make()``, named ``name``) as a
    tensor on ``like``'s device, in ``like``'s dtype or ``dtype``, copied
    once (``spatial.device_const``)."""
    return sp.device_const(model, name, make or (lambda: getattr(model, name)), like, dtype)


def _idx(model, name: str, like, make=None):
    """A static host index of the model on ``like``'s device."""
    return _c(model, name, like, make, torch.long)


# ------------------------------------------------------------------------- FK


def joint_rot_mats(model: PhysicsModel, dof_pos):
    """Per-joint rotation matrices from hinge angles: [N, nb-1, 3, 3]."""
    axes = _c(model, "joint_axis", dof_pos)[1:]                # [nb-1, 3]
    c = torch.cos(dof_pos)[..., None, None]
    s = torch.sin(dof_pos)[..., None, None]
    K = sp.skew(axes)                                          # [nb-1, 3, 3]
    KK = K @ K
    eye = torch.eye(3, dtype=dof_pos.dtype, device=dof_pos.device)
    return eye + s * K + (1.0 - c) * KK                        # Rodrigues


def forward_kinematics(model: PhysicsModel, state: SimState):
    """World pose of every body: (pos [N, nb, 3], rot [N, nb, 3, 3])."""
    like = state.root_pos
    local_pos = _c(model, "local_pos", like)
    L = _c(model, "local_rot_mats", like, lambda: _local_rot_mats(model, torch.float32))
    J = joint_rot_mats(model, state.dof_pos)                   # [N, nb-1, 3, 3]

    W0 = rot.quat_to_matrix(state.root_quat)                   # [N, 3, 3]
    pos = [state.root_pos]
    W = [W0]
    for i in range(1, model.nb):
        p = int(model.parent[i])
        W.append(W[p] @ (L[i] @ J[:, i - 1]))
        pos.append(pos[p] + torch.einsum("nij,j->ni", W[p], local_pos[i]))
    return torch.stack(pos, dim=1), torch.stack(W, dim=1)


def _body_world_velocities(model: PhysicsModel, state: SimState, body_rot):
    """Angular velocity and origin linear velocity of every body (world).

    Outward recursion mirroring FK: omega_i = omega_p + W_i a_i qd_i,
    v_i = v_p + omega_p x (o_i - o_p).
    """
    like = state.root_pos
    axes = _c(model, "joint_axis", like)
    local_pos = _c(model, "local_pos", like)

    omega = [state.root_ang_vel]
    vel = [state.root_vel]
    W = body_rot
    for i in range(1, model.nb):
        p = int(model.parent[i])
        r = torch.einsum("nij,j->ni", W[:, p], local_pos[i])   # o_i - o_p world
        omega.append(omega[p] + torch.einsum("nij,j->ni", W[:, i], axes[i])
                     * state.dof_vel[:, i - 1: i])
        vel.append(vel[p] + sp.cross3(omega[p], r))
    return torch.stack(omega, dim=1), torch.stack(vel, dim=1)


# -------------------------------------------------------------------- contacts


def contact_forces(model: PhysicsModel, params: EngineParams, body_pos, body_rot, state, dt):
    """Point-vs-ground-plane compliant contacts.

    Returns (f_ext_w [N, nb, 6] spatial forces about each body origin in
    world coords, body_contact [N, nb] normal-force indicator).

    Normal: critically-damped spring (effective-mass scaled) with stiffness
    from ``contact_timeconst``.  Friction: Coulomb cone with an impulse
    clamp: the tangential force never exceeds what would reverse the slip
    velocity within one substep.  Explicit (load-bearing) points keep the
    load-scaled stiffness; auto points get the rotation-aware stability cap.
    """
    like = body_pos
    cp_body = _idx(model, "cp_body", like)                     # [P]
    cp_pos = _c(model, "cp_pos", like)                         # [P, 3]
    cp_radius = _c(model, "cp_radius", like)
    cp_mass = _c(model, "cp_mass", like)
    cp_mass_local = _c(model, "cp_mass_local", like)

    Wb = body_rot[:, cp_body]                                  # [N, P, 3, 3]
    ob = body_pos[:, cp_body]                                  # [N, P, 3]
    r_w = torch.einsum("npij,pj->npi", Wb, cp_pos)             # lever arm world
    x_w = ob + r_w                                             # point world pos

    # point velocity: v = v_body_origin + omega_body x r
    omega_w, v_origin_w = _body_world_velocities(model, state, body_rot)
    v_pt = v_origin_w[:, cp_body] + sp.cross3(omega_w[:, cp_body], r_w)

    phi = x_w[..., 2] - cp_radius                              # penetration (<0)
    pen = torch.clamp_min(-phi, 0.0)
    active = phi < 0.0

    omega_n = 2.0 / params.contact_timeconst
    cp_mass_stab = _c(model, "cp_mass_stab", like)
    explicit = _c(model, "cp_explicit", like, dtype=torch.bool)
    k_cap = torch.where(explicit, torch.inf, 0.25 * cp_mass_stab / (dt * dt))
    b_cap = torch.where(explicit, cp_mass_local / dt, 0.5 * cp_mass_stab / dt)
    k = torch.minimum(cp_mass * omega_n * omega_n, k_cap)
    b = torch.minimum(2.0 * params.contact_dampratio * cp_mass * omega_n, b_cap)
    fn = torch.clamp_min(k * pen - b * v_pt[..., 2], 0.0) * active

    v_t = v_pt[..., 0:2]
    speed = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + 1e-10)
    stick_mass = torch.where(explicit, cp_mass_local, cp_mass_stab)
    f_stick = stick_mass * speed / dt
    mu = params.friction_mu
    if isinstance(mu, torch.Tensor):
        mu = mu.to(like)
        mu = mu[:, None] if mu.ndim == 1 else mu               # [N] per env -> [N, 1]
    f_t_mag = torch.minimum(mu * fn, f_stick)
    f_t = -(f_t_mag / speed)[..., None] * v_t

    f_w = torch.cat([f_t, fn[..., None]], dim=-1)              # [N, P, 3]
    tau_w = sp.cross3(r_w, f_w)
    f_sp = torch.cat([tau_w, f_w], dim=-1)                     # [N, P, 6]

    f_ext = sp.index_sum(f_sp, model.cp_body, model.nb)
    contact = sp.index_sum(fn[..., None], model.cp_body, model.nb)[..., 0]
    return f_ext, contact


def _sc_pair_terms(model: PhysicsModel, params: EngineParams, body_pos, body_rot,
                   omega_w, v_origin_w, dt):
    """Per sphere pair of the self-collision module: lever arms r_w [N, S, 3],
    the direction n [N, Q, 3] and the force magnitude fmag [N, Q]."""
    like = body_pos
    scb = _idx(model, "sc_body", like)
    Wb = body_rot[:, scb]                                    # [N, S, 3, 3]
    r_w = torch.einsum("nsij,sj->nsi", Wb, _c(model, "sc_pos", like))
    x_w = body_pos[:, scb] + r_w                             # [N, S, 3]
    v_pt = v_origin_w[:, scb] + sp.cross3(omega_w[:, scb], r_w)

    ia = _idx(model, "sc_ia", like, lambda: model.sc_pairs[:, 0])
    ib = _idx(model, "sc_ib", like, lambda: model.sc_pairs[:, 1])
    d = x_w[:, ia] - x_w[:, ib]                              # [N, Q, 3]
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    pen = _c(model, "sc_rsum", like, lambda: model.sc_radius[model.sc_pairs[:, 0]]
             + model.sc_radius[model.sc_pairs[:, 1]]) - dist
    active = (pen > 0.0).to(like.dtype)
    n = d / dist[..., None]

    omega_n = 2.0 / params.contact_timeconst
    m = np.asarray(model.sc_stiff_mass, np.float64)
    rates = f"sc_rates/{dt!r}/{params.contact_timeconst!r}"
    k = _c(model, rates + "/k", like, lambda: np.minimum(
        m * omega_n * omega_n, 0.25 * m / (dt * dt)).astype(np.float32))
    b = _c(model, rates + "/b", like, lambda: np.minimum(
        2.0 * m * omega_n, 0.5 * m / dt).astype(np.float32))

    vn = torch.sum((v_pt[:, ia] - v_pt[:, ib]) * n, dim=-1)
    fmag = torch.clamp_min(k * pen - b * vn, 0.0) * active   # [N, Q]
    return r_w, n, fmag


def self_collision_forces(model: PhysicsModel, params: EngineParams, body_pos, body_rot,
                          omega_w, v_origin_w, dt):
    """Sphere-sphere self-collision penalty forces.

    Returns f_ext_sc [N, nb, 6] world spatial forces about body origins.
    Spheres/pairs come from the model build (rest-pose-pruned); the
    spring/damper rates follow the ground-contact stability caps.
    """
    N = body_pos.shape[0]
    if model.sc_pairs.size == 0 or not params.self_collision:
        return body_pos.new_zeros((N, model.nb, 6))
    r_w, n, fmag = _sc_pair_terms(model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
    f = fmag[..., None] * n                                  # on sphere a
    ia, ib = model.sc_pairs[:, 0], model.sc_pairs[:, 1]
    tau_a = sp.cross3(r_w[:, _idx(model, "sc_ia", body_pos, lambda: ia)], f)
    tau_b = sp.cross3(r_w[:, _idx(model, "sc_ib", body_pos, lambda: ib)], -f)
    w = torch.cat([torch.cat([tau_a, f], dim=-1), torch.cat([tau_b, -f], dim=-1)], dim=1)
    scb = model.sc_body
    return sp.index_sum(w, np.concatenate([scb[ia], scb[ib]]), model.nb)


GROUND = -1  # link_b value for robot-vs-ground pairs


def contact_pairs(model: PhysicsModel, params: EngineParams, state: SimState):
    """Generic "who touched whom" query with static shapes.

    The pair table is static (every collidable body vs the ground plane,
    plus every curated self-collision body pair); validity and forces are
    per-env device tensors.

    Returns a dict:
      link_a   [Q] int32 (numpy, static) — body index
      link_b   [Q] int32 (numpy, static) — body index or GROUND (-1)
      force    [N, Q] float — contact normal-force magnitude
      valid    [N, Q] bool  — force > 0
    """
    body_pos, body_rot = forward_kinematics(model, state)
    dt = params.ctrl_dt / params.substeps

    # ground pairs: bodies owning contact points, in body order
    ground_bodies = np.unique(np.asarray(model.cp_body))
    _, per_body = contact_forces(model, params, body_pos, body_rot, state, dt)
    link_a = [ground_bodies.astype(np.int32)]
    link_b = [np.full(len(ground_bodies), GROUND, np.int32)]
    forces = [per_body[:, torch.as_tensor(ground_bodies, device=body_pos.device)]]

    if model.sc_pairs.size and params.self_collision:
        scb = model.sc_body
        ia, ib = model.sc_pairs[:, 0], model.sc_pairs[:, 1]
        # sphere pairs -> unique body-level pairs (static mapping)
        bp_sorted = np.sort(np.stack([scb[ia], scb[ib]], axis=1), axis=1)
        uniq, inv = np.unique(bp_sorted, axis=0, return_inverse=True)
        omega_w, v_origin_w = _body_world_velocities(model, state, body_rot)
        _, _, fmag = _sc_pair_terms(model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
        agg = sp.index_sum(fmag[..., None], inv.reshape(-1), len(uniq))[..., 0]
        link_a.append(uniq[:, 0].astype(np.int32))
        link_b.append(uniq[:, 1].astype(np.int32))
        forces.append(agg)

    force = torch.cat(forces, dim=1)
    # report the forces the dynamics actually applied: under a mass scale
    # the substep scales contact forces by it
    ms = mass_scale_or_none(params)
    if ms is not None:
        force = force * ms.to(force.device)[:, None]
    return dict(
        link_a=np.concatenate(link_a),
        link_b=np.concatenate(link_b),
        force=force,
        valid=force > 0.0,
    )


def narrowphase_f_ext(model: PhysicsModel, params: EngineParams,
                      body_pos, body_rot, omega_w, v_origin_w, dt):
    """Optional narrowphase contact wrenches: capsule pairs + general
    geom-geom pairs (physics/narrowphase.py).  Returns [N, nb, 6] or None
    when the model opted into neither."""
    out = None
    if model.capsules is not None and model.capsules.num_pairs:
        out = capsule_f_ext(model.capsules, body_pos, body_rot, omega_w, v_origin_w, dt,
                            params.contact_timeconst, model.nb)
    if model.geoms is not None and model.geoms.num_pairs:
        g = geom_f_ext(model.geoms, body_pos, body_rot, omega_w, v_origin_w, dt,
                       params.contact_timeconst, model.nb)
        out = g if out is None else out + g
    return out


def _needs_np(model: PhysicsModel) -> bool:
    return bool((model.capsules is not None and model.capsules.num_pairs)
                or (model.geoms is not None and model.geoms.num_pairs))


# ----------------------------------------------------------------------- step


def substep(model: PhysicsModel, params: EngineParams, state: SimState, dt: float,
            held_f_ext=None):
    """One physics substep: contacts -> PD torque -> ABA -> integrate.

    ``held_f_ext`` carries the slow contact forces precomputed once per
    control step (self-collision + capsule/geom narrowphase, see
    :func:`step`); when None they are all evaluated live here.
    """
    body_pos, body_rot = forward_kinematics(model, state)
    f_ext_w, contact = contact_forces(model, params, body_pos, body_rot, state, dt)
    if held_f_ext is not None:
        f_ext_w = f_ext_w + held_f_ext
    else:
        need_sc = params.self_collision and model.sc_pairs.size
        need_np = _needs_np(model)
        if need_sc or need_np:
            omega_w, v_origin_w = _body_world_velocities(model, state, body_rot)
            if need_sc:
                f_ext_w = f_ext_w + self_collision_forces(
                    model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
            if need_np:
                f_ext_w = f_ext_w + narrowphase_f_ext(
                    model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
    ms = mass_scale_or_none(params)
    if ms is not None:
        # contact/self-collision springs are mass-proportional: penetration
        # depth stays mass-invariant (fused_step._substep_core semantics)
        ms = ms.to(body_pos.device)
        f_ext_w = f_ext_w * ms[:, None, None]
        contact = contact * ms[:, None]

    # PD torque (explicit part)
    q, qd = state.dof_pos, state.dof_vel
    kp = torch.as_tensor(params.kp, dtype=q.dtype, device=q.device)
    kv = torch.as_tensor(params.kv, dtype=q.dtype, device=q.device)
    tau_pd = torch.clamp(kp * (state.pd_target - q) - kv * qd,
                         -params.max_torque, params.max_torque)

    damping = _c(model, "dof_damping", q)
    friction = _c(model, "dof_friction", q)
    tau = tau_pd - damping * qd - friction * torch.tanh(qd / 0.05)

    # joint-limit penalty torque (springy stop + damping when violating)
    lo = _c(model, "dof_lo", q, lambda: model.dof_limit[:, 0])
    hi = _c(model, "dof_hi", q, lambda: model.dof_limit[:, 1])
    k_lim = 400.0
    tau = tau + k_lim * torch.clamp_min(lo - q, 0.0) - k_lim * torch.clamp_min(q - hi, 0.0)

    # root spatial velocity in root body coords
    W0 = body_rot[:, 0]
    w_b = torch.einsum("nji,nj->ni", W0, state.root_ang_vel)
    v_b = torch.einsum("nji,nj->ni", W0, state.root_vel)
    root_vel_b = torch.cat([w_b, v_b], dim=-1)

    joint_rot = joint_rot_mats(model, state.dof_pos)
    qdd, root_acc = aba(
        model, body_rot, root_vel_b, qd, joint_rot, tau, f_ext_w, damping + kv, dt,
        gravity=params.gravity, ms=ms,
    )

    # --- semi-implicit Euler
    # root: convert body-frame spatial acc to world classical acc
    wdot_w = torch.einsum("nij,nj->ni", W0, root_acc[:, 0:3])
    a_lin_w = torch.einsum("nij,nj->ni", W0, root_acc[:, 3:6]) + sp.cross3(
        state.root_ang_vel, state.root_vel)
    root_ang_vel = state.root_ang_vel + dt * wdot_w
    root_vel = state.root_vel + dt * a_lin_w
    root_pos = state.root_pos + dt * root_vel
    dq = rot.exp_map_to_quat(dt * root_ang_vel)
    root_quat = rot.quat_normalize(rot.quat_mul(dq, state.root_quat))

    dof_vel = qd + dt * qdd
    dof_pos = q + dt * dof_vel

    # hard joint-limit projection backstop: clamp + kill outward velocity
    zero = torch.zeros_like(dof_vel)
    dof_vel = torch.where((dof_pos > hi) & (dof_vel > 0), zero, dof_vel)
    dof_vel = torch.where((dof_pos < lo) & (dof_vel < 0), zero, dof_vel)
    dof_pos = torch.minimum(torch.maximum(dof_pos, lo), hi)

    # global velocity guards: keep post-failure states finite
    vmax = 100.0
    new_state = SimState(
        root_pos=root_pos,
        root_quat=root_quat,
        root_vel=torch.clamp(root_vel, -vmax, vmax),
        root_ang_vel=torch.clamp(root_ang_vel, -vmax, vmax),
        dof_pos=dof_pos,
        dof_vel=torch.clamp(dof_vel, -vmax, vmax),
        pd_target=state.pd_target,
    )
    return new_state, contact


def step(model: PhysicsModel, params: EngineParams, state: SimState, pd_target):
    """One control step = clamp/slew PD target + ``substeps`` physics substeps.

    Returns (new_state, body_contact [N, nb] — normal force accumulated on
    each body over the last substep, used for contact termination).
    """
    tgt = apply_pd_target(model, params, state, pd_target)
    state = SimState(
        root_pos=state.root_pos, root_quat=state.root_quat, root_vel=state.root_vel,
        root_ang_vel=state.root_ang_vel, dof_pos=state.dof_pos, dof_vel=state.dof_vel,
        pd_target=tgt,
    )
    dt = params.ctrl_dt / params.substeps

    # self-collision + narrowphase forces vary slowly vs the 400 Hz substep
    # rate: evaluate once per control step and hold (as fused_step and the
    # kernel do)
    held_f_ext = None
    need_sc = params.self_collision and model.sc_pairs.size
    need_np = _needs_np(model)
    if need_sc or need_np:
        body_pos, body_rot = forward_kinematics(model, state)
        omega_w, v_origin_w = _body_world_velocities(model, state, body_rot)
        if need_sc:
            held_f_ext = self_collision_forces(
                model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
        if need_np:
            np_ext = narrowphase_f_ext(model, params, body_pos, body_rot, omega_w, v_origin_w, dt)
            held_f_ext = np_ext if held_f_ext is None else held_f_ext + np_ext

    contact = None
    for _ in range(params.substeps):
        state, contact = substep(model, params, state, dt, held_f_ext)
    return state, contact
