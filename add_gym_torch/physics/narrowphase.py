"""Geom-geom narrowphase collision (optional contact module).

Counterpart of ``add_gym_tpu/physics/narrowphase.py``: static-shape pair
tables evaluated as batched closest-point queries, no broadphase and no
dynamic contact counts.  Two tiers:

- :class:`CapsuleSet` / :func:`capsule_f_ext` — capsule/cylinder pairs
  only, evaluated by the reference-layout engine (``engine.step``).
- :class:`GeomSet` / :func:`geom_f_ext` — the general module: spheres,
  capsules and cylinders unify into segments (a sphere is a zero-length
  capsule), plus oriented boxes with exact point-box, fixed-iteration
  segment-box and vertex-manifold box-box queries.  It runs on every
  backend: inline per substep in ``engine.substep`` without held forces,
  and as held per-control-step wrenches (``fused_step.compute_np_ext``) in
  the plain step and in the CUDA kernel, which takes them as
  ``6 * n_touched`` extra input rows.

Forces use the engine's mass-proportional spring-damper with the dt
stability clamp (``engine.self_collision_forces``).  The per-body sums go
through ``spatial.index_sum`` (a fixed order of additions) instead of
JAX's scatter-add, so they are the same bits on every run of a CUDA
device; they differ from JAX's order by f32 rounding only.

Host-side table building (``parse_geoms``, ``rest_pose_prune``,
``parse_capsules``) keeps the JAX package's arithmetic: its distance tests
run in f32, as the JAX host code does, so both packages keep the same pairs.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np
import torch

from add_gym_torch.physics.spatial import cross3, device_const, index_sum


@dataclass(frozen=True)
class CapsuleSet:
    """Static capsule geometry + candidate pair table (host constants)."""

    body: np.ndarray        # [C] body index
    p0: np.ndarray          # [C, 3] segment start, body frame
    p1: np.ndarray          # [C, 3] segment end, body frame
    radius: np.ndarray      # [C]
    pairs: np.ndarray       # [P, 2] capsule indices
    stiff_mass: np.ndarray  # [P] effective mass for the contact spring

    @property
    def num_pairs(self) -> int:
        return int(self.pairs.shape[0]) if self.pairs.size else 0


EMPTY_CAPSULES = CapsuleSet(
    body=np.zeros((0,), np.int32),
    p0=np.zeros((0, 3), np.float32),
    p1=np.zeros((0, 3), np.float32),
    radius=np.zeros((0,), np.float32),
    pairs=np.zeros((0, 2), np.int32),
    stiff_mass=np.zeros((0,), np.float32),
)


def _consts(owner, like):
    """``c(name, make, dtype=None)``: the host array ``make()`` of the
    static table ``owner`` as a tensor on ``like``'s device (built once,
    ``spatial.device_const``); ``dtype=torch.long`` for an index."""
    return lambda name, make, dtype=None: device_const(owner, name, make, like, dtype)


def segment_closest_points(a0, a1, b0, b1, eps: float = 1e-9):
    """Closest points between segments [a0,a1] and [b0,b1].

    Batched over arbitrary leading dims; returns (pa, pb) points.  Clamped
    quadratic minimization (Ericson, Real-Time Collision Detection §5.1.9)
    with eps guards so degenerate (zero-length) segments reduce to points,
    branch-free.
    """
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    denom = a * e - b * b

    # first candidate for s (parallel / degenerate -> 0), then alternate
    # projections with clamping (two passes reach the true optimum for
    # all clamp configurations)
    zero = torch.zeros_like(a)
    s = torch.where(denom > eps, (b * f - c * e) / torch.clamp_min(denom, eps), zero)
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(e > eps, (b * s + f) / torch.clamp_min(e, eps), zero)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.where(a > eps, (b * t - c) / torch.clamp_min(a, eps), zero)
    s = torch.clamp(s, 0.0, 1.0)

    pa = a0 + s[..., None] * d1
    pb = b0 + t[..., None] * d2
    return pa, pb


def _spring_rates(mass, dt: float, contact_timeconst: float):
    """Critically-damped spring and damper rates with the dt-stability clamp
    (float64 on the host, handed out as f32)."""
    omega_n = 2.0 / contact_timeconst
    m = np.asarray(mass, np.float64)
    k = np.minimum(m * omega_n * omega_n, 0.25 * m / (dt * dt)).astype(np.float32)
    bd = np.minimum(2.0 * m * omega_n, 0.5 * m / dt).astype(np.float32)
    return k, bd


def capsule_pair_forces(
    caps: CapsuleSet, body_pos, body_rot, omega_w, v_origin_w, dt: float,
    contact_timeconst: float,
):
    """Spring-damper contact forces for every capsule pair.

    Args mirror engine.self_collision_forces: body_pos/body_rot [N, nb, ...]
    world-frame FK, omega_w/v_origin_w [N, nb, 3] world body velocities.

    Returns (force_on_a [N, P, 3], point_a [N, P, 3], point_b [N, P, 3],
    fmag [N, P]): equal-and-opposite forces applied at the closest points.
    """
    c = _consts(caps, body_pos)
    L = torch.long
    cb = c("body", lambda: caps.body, L)
    Wb = body_rot[:, cb]                                     # [N, C, 3, 3]
    e0 = body_pos[:, cb] + torch.einsum("ncij,cj->nci", Wb, c("p0", lambda: caps.p0))
    e1 = body_pos[:, cb] + torch.einsum("ncij,cj->nci", Wb, c("p1", lambda: caps.p1))

    ia, ib = c("ia", lambda: caps.pairs[:, 0], L), c("ib", lambda: caps.pairs[:, 1], L)
    pa, pb = segment_closest_points(e0[:, ia], e1[:, ia], e0[:, ib], e1[:, ib])
    d = pa - pb
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    pen = c("rsum", lambda: caps.radius[caps.pairs[:, 0]] + caps.radius[caps.pairs[:, 1]]) - dist
    active = (pen > 0.0).to(body_pos.dtype)
    n = d / dist[..., None]

    rates = f"rates/{dt!r}/{contact_timeconst!r}"
    k = c(rates + "/k", lambda: _spring_rates(caps.stiff_mass, dt, contact_timeconst)[0])
    bd = c(rates + "/b", lambda: _spring_rates(caps.stiff_mass, dt, contact_timeconst)[1])
    ba = c("ba", lambda: caps.body[caps.pairs[:, 0]], L)
    bb = c("bb", lambda: caps.body[caps.pairs[:, 1]], L)
    ra = pa - body_pos[:, ba]
    rb = pb - body_pos[:, bb]
    va = v_origin_w[:, ba] + cross3(omega_w[:, ba], ra)
    vb = v_origin_w[:, bb] + cross3(omega_w[:, bb], rb)
    vn = torch.sum((va - vb) * n, dim=-1)

    fmag = torch.clamp_min(k * pen - bd * vn, 0.0) * active
    f = fmag[..., None] * n
    return f, pa, pb, fmag


def _wrenches(parts, N: int, nb: int, like):
    """Sum (bodies [K], torque [N, K, 3], force [N, K, 3]) parts into an
    [N, nb, 6] f_ext delta, in a fixed order."""
    if not parts:
        return like.new_zeros((N, nb, 6))
    bodies = np.concatenate([b for b, _, _ in parts])
    w = torch.cat([torch.cat([t, f], dim=-1) for _, t, f in parts], dim=1)
    return index_sum(w, bodies, nb)


def capsule_f_ext(caps: CapsuleSet, body_pos, body_rot, omega_w, v_origin_w,
                  dt: float, contact_timeconst: float, nb: int):
    """Accumulate capsule-pair contact wrenches into an [N, nb, 6] f_ext
    delta ([torque, force] about each body origin, world frame)."""
    f, pa, pb, _ = capsule_pair_forces(
        caps, body_pos, body_rot, omega_w, v_origin_w, dt, contact_timeconst
    )
    ba, bb = caps.body[caps.pairs[:, 0]], caps.body[caps.pairs[:, 1]]
    c = _consts(caps, body_pos)
    tau_a = cross3(pa - body_pos[:, c("ba", lambda: ba, torch.long)], f)
    tau_b = cross3(pb - body_pos[:, c("bb", lambda: bb, torch.long)], -f)
    return _wrenches([(ba, tau_a, f), (bb, tau_b, -f)], body_pos.shape[0], nb, body_pos)


# --------------------------------------------------------------------------
# General geom-geom narrowphase: spheres/capsules/cylinders unify into
# segments (a sphere is a zero-length capsule), boxes get their own closest-
# point queries.  Three static pair tables (seg-seg, seg-box, box-box) keep
# everything fixed-shape and branch-free; contact *candidates* are static
# and activation is a mask.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GeomSet:
    """Static collision geometry + candidate pair tables (host constants).

    Segments cover sphere (p0 == p1), capsule and cylinder geoms; boxes are
    oriented half-extent boxes.  Pair tables index into these arrays:
    ``ss_pairs`` [P,2] (segment, segment), ``sb_pairs`` [Q,2] (segment,
    box), ``bb_pairs`` [R,2] (box, box).
    """

    seg_body: np.ndarray    # [S] body index
    seg_p0: np.ndarray      # [S, 3] body frame
    seg_p1: np.ndarray      # [S, 3]
    seg_radius: np.ndarray  # [S]
    box_body: np.ndarray    # [B] body index
    box_pos: np.ndarray     # [B, 3] center, body frame
    box_rot: np.ndarray     # [B, 3, 3] box->body rotation
    box_half: np.ndarray    # [B, 3] half extents
    ss_pairs: np.ndarray    # [P, 2]
    ss_mass: np.ndarray     # [P]
    sb_pairs: np.ndarray    # [Q, 2]
    sb_mass: np.ndarray     # [Q]
    bb_pairs: np.ndarray    # [R, 2]
    bb_mass: np.ndarray     # [R]

    @property
    def num_pairs(self) -> int:
        return int(
            self.ss_pairs.shape[0] + self.sb_pairs.shape[0]
            + self.bb_pairs.shape[0]
        )


def box_surface_point(l, h, eps: float = 1e-9):
    """Closest surface point of an axis-aligned box to local point(s) ``l``.

    ``l`` [..., 3] local coordinates, ``h`` [..., 3] half extents.  Returns
    (q, n, sd): surface point, outward normal and *signed* distance —
    positive outside, negative inside (push-out to the nearest face).
    Branch-free, batched over leading dims.  An interior point equally near
    two faces leaves through the first of them (``torch.argmin`` and
    ``jnp.argmin`` both pick the first minimum).
    """
    h = h.expand(l.shape)
    lc = torch.minimum(torch.maximum(l, -h), h)
    delta = l - lc
    out_d = torch.sqrt(torch.sum(delta * delta, dim=-1) + eps)
    outside = torch.any(torch.abs(l) > h, dim=-1)

    # interior: push out through the nearest face
    face_d = h - torch.abs(l)                           # [..., 3] >= 0 inside
    k = torch.argmin(face_d, dim=-1)
    onehot = torch.nn.functional.one_hot(k, 3).to(l.dtype)
    lk = torch.gather(l, -1, k[..., None])[..., 0]
    sgn = torch.where(lk >= 0, 1.0, -1.0).to(l.dtype)
    n_in = sgn[..., None] * onehot
    q_in = l * (1.0 - onehot) + n_in * h
    d_in = -torch.amin(face_d, dim=-1)

    n_out = delta / out_d[..., None]
    q = torch.where(outside[..., None], lc, q_in)
    n = torch.where(outside[..., None], n_out, n_in)
    sd = torch.where(outside, out_d, d_in)
    return q, n, sd


def segment_box_closest(a, b, h, iters: int = 4):
    """Closest point between segment [a, b] and an axis-aligned box, in the
    box's local frame.  A fixed-count ternary search on the squared
    distance (convex along the segment) finds the best t, then a few
    segment->box->segment projection rounds refine it toward the deepest
    point when the segment penetrates.  Returns (p, q, n, sd): segment
    point, box surface point, outward box normal at q, signed distance of
    p to the box.
    """
    d = b - a
    h = h.expand(a.shape)

    # dist^2(seg(t), box) is convex in t (distance to a convex set along a
    # line), so a fixed-count ternary search is provably convergent: 24
    # rounds shrink [0,1] by (2/3)^24 ~ 6e-5.
    def f(t):
        p = a + t[..., None] * d
        cl = torch.minimum(torch.maximum(p, -h), h)
        return torch.sum(torch.square(p - cl), dim=-1)

    lo = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    hi = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    for _ in range(24):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        left = f(m1) < f(m2)
        lo = torch.where(left, lo, m1)
        hi = torch.where(left, m2, hi)
    t = 0.5 * (lo + hi)

    # penetration case: f == 0 on an interval; refine toward the deepest
    # point with a few alternating projections on the *surface* query
    dd = torch.clamp_min(torch.sum(d * d, dim=-1), 1e-12)
    for _ in range(iters):
        p = a + t[..., None] * d
        q, _, sd = box_surface_point(p, h)
        t_new = torch.clamp(torch.sum((q - a) * d, dim=-1) / dd, 0.0, 1.0)
        t = torch.where(sd < 0, t, t_new)
    p = a + t[..., None] * d
    q, n, sd = box_surface_point(p, h)
    return p, q, n, sd


def _pair_spring(k, bd, pen, vn):
    """The engine's critically-damped contact spring with the dt-stability
    clamp (rates from :func:`_spring_rates`): force magnitude [N, P]."""
    active = (pen > 0.0).to(pen.dtype)
    return torch.clamp_min(k * pen - bd * vn, 0.0) * active


def _point_velocity(body_pos, omega_w, v_origin_w, b, p):
    """World velocity of point ``p`` [N, P, 3] on bodies ``b`` [P]."""
    return v_origin_w[:, b] + cross3(omega_w[:, b], p - body_pos[:, b])


_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32,
)                                                            # [8, 3]


def geom_f_ext(gs: GeomSet, body_pos, body_rot, omega_w, v_origin_w,
               dt: float, contact_timeconst: float, nb: int, active: dict | None = None):
    """Accumulate all geom-geom narrowphase contact wrenches into an
    [N, nb, 6] f_ext delta ([torque, force] about body origins, world).

    seg-seg contacts are exact; seg-box uses the fixed-iteration
    alternating projection; box-box applies a vertex-contact model (each
    penetrating vertex of A in B and of B in A contributes a push-out
    spring — face-face rests get the stable 4-vertex manifold; deep
    symmetric overlap may double-count, acceptable for a penalty model).
    The 8 vertex wrenches of a box pair are summed onto the pair before the
    per-body sum.  The tables' constants and indices come from the device
    cache (``spatial.device_const``), so a call copies nothing to the card.
    A dict ``active`` receives, per table ("ss", "sb", "bb"), whether each
    pair pushes ([N, pairs] bool; a box pair with any vertex of either box
    in contact).
    """
    N = body_pos.shape[0]
    c = _consts(gs, body_pos)
    L = torch.long
    rates = f"rates/{dt!r}/{contact_timeconst!r}"
    parts = []

    def apply(tag, ba, bb_, pa, pb, n, pen, mass, vertices=False):
        """Spring force along n on bodies ``ba`` at pa, reaction on ``bb_``
        at pb; ``tag`` names the pair table in the device cache."""
        if vertices:                                         # [N, R, 8, ...]
            flat = lambda x: x.reshape((N, -1) + x.shape[3:])
            pa, pb, n, pen = flat(pa), flat(pb), flat(n), flat(pen)
            rep = lambda x: np.repeat(x, 8)
        else:
            rep = lambda x: x
        ia = c(tag + "/ba", lambda: rep(ba), L)
        ib = c(tag + "/bb", lambda: rep(bb_), L)
        va = _point_velocity(body_pos, omega_w, v_origin_w, ia, pa)
        vb = _point_velocity(body_pos, omega_w, v_origin_w, ib, pb)
        vn = torch.sum((va - vb) * n, dim=-1)
        k = c(f"{tag}/{rates}/k", lambda: rep(_spring_rates(mass, dt, contact_timeconst)[0]))
        bd = c(f"{tag}/{rates}/b", lambda: rep(_spring_rates(mass, dt, contact_timeconst)[1]))
        fmag = _pair_spring(k, bd, pen, vn)
        if active is not None:
            hit = (fmag > 0).reshape(N, -1, 8).any(-1) if vertices else fmag > 0
            key = tag[:2]
            active[key] = hit | active[key] if key in active else hit
        f = fmag[..., None] * n
        tau_a = cross3(pa - body_pos[:, ia], f)
        tau_b = cross3(pb - body_pos[:, ib], -f)
        fb = -f
        if vertices:
            unflat = lambda x: x.reshape(N, -1, 8, 3).sum(2)
            tau_a, f, tau_b, fb = unflat(tau_a), unflat(f), unflat(tau_b), unflat(fb)
        parts.append((ba, tau_a, f))
        parts.append((bb_, tau_b, fb))

    # world-frame segment endpoints / box frames
    if gs.seg_body.size:
        sb = c("seg_body", lambda: gs.seg_body, L)
        Wb = body_rot[:, sb]
        e0 = body_pos[:, sb] + torch.einsum("nsij,sj->nsi", Wb, c("seg_p0", lambda: gs.seg_p0))
        e1 = body_pos[:, sb] + torch.einsum("nsij,sj->nsi", Wb, c("seg_p1", lambda: gs.seg_p1))
    if gs.box_body.size:
        bbod = c("box_body", lambda: gs.box_body, L)
        # box->world rotation and world center
        Rw = torch.einsum("nbij,bjk->nbik", body_rot[:, bbod], c("box_rot", lambda: gs.box_rot))
        cw = body_pos[:, bbod] + torch.einsum(
            "nbij,bj->nbi", body_rot[:, bbod], c("box_pos", lambda: gs.box_pos))

    if gs.ss_pairs.size:
        ia, ib = gs.ss_pairs[:, 0], gs.ss_pairs[:, 1]
        ti, tj = c("ss/i", lambda: ia, L), c("ss/j", lambda: ib, L)
        pa, pb = segment_closest_points(e0[:, ti], e1[:, ti], e0[:, tj], e1[:, tj])
        dvec = pa - pb
        dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + 1e-12)
        pen = c("ss/rsum", lambda: gs.seg_radius[ia] + gs.seg_radius[ib]) - dist
        n = dvec / dist[..., None]
        apply("ss", gs.seg_body[ia], gs.seg_body[ib], pa, pb, n, pen, gs.ss_mass)

    if gs.sb_pairs.size:
        si, bi = gs.sb_pairs[:, 0], gs.sb_pairs[:, 1]
        ts, tb = c("sb/s", lambda: si, L), c("sb/b", lambda: bi, L)
        # segment endpoints into each box's local frame
        Rl, cl = Rw[:, tb], cw[:, tb]
        al = torch.einsum("nqji,nqj->nqi", Rl, e0[:, ts] - cl)
        bl = torch.einsum("nqji,nqj->nqi", Rl, e1[:, ts] - cl)
        p, q, nl, sd = segment_box_closest(al, bl, c("sb/half", lambda: gs.box_half[bi]))
        pen = c("sb/radius", lambda: gs.seg_radius[si]) - sd
        pw = cl + torch.einsum("nqij,nqj->nqi", Rl, p)
        qw = cl + torch.einsum("nqij,nqj->nqi", Rl, q)
        nw = torch.einsum("nqij,nqj->nqi", Rl, nl)
        apply("sb", gs.seg_body[si], gs.box_body[bi], pw, qw, nw, pen, gs.sb_mass)

    if gs.bb_pairs.size:
        for tag, (src, dst) in (("bb0", (gs.bb_pairs[:, 0], gs.bb_pairs[:, 1])),
                                ("bb1", (gs.bb_pairs[:, 1], gs.bb_pairs[:, 0]))):
            tsrc, tdst = c(tag + "/src", lambda: src, L), c(tag + "/dst", lambda: dst, L)
            # 8 vertices of src box in world, then into dst box local frame
            vloc = c(tag + "/vloc", lambda: _CORNERS[None] * gs.box_half[src][:, None, :])
            vw = cw[:, tsrc, None, :] + torch.einsum("nrij,rvj->nrvi", Rw[:, tsrc], vloc)
            Rd, cd = Rw[:, tdst], cw[:, tdst]
            vl = torch.einsum("nrji,nrvj->nrvi", Rd, vw - cd[:, :, None, :])
            hd = c(tag + "/half", lambda: gs.box_half[dst])[None, :, None, :]
            q, nl, sd = box_surface_point(vl, hd)
            qw = cd[:, :, None, :] + torch.einsum("nrij,nrvj->nrvi", Rd, q)
            nw = torch.einsum("nrij,nrvj->nrvi", Rd, nl)
            apply(tag, gs.box_body[src], gs.box_body[dst], vw, qw, nw, -sd, gs.bb_mass,
                  vertices=True)
    return _wrenches(parts, N, nb, body_pos)


def touched_bodies(caps: CapsuleSet | None, gs: GeomSet | None) -> np.ndarray:
    """Sorted bodies that any capsule or geom pair table can touch: the
    static set of held narrowphase wrenches."""
    touched = []
    if caps is not None and caps.num_pairs:
        touched.append(caps.body[caps.pairs.ravel()])
    if gs is not None and gs.num_pairs:
        touched.append(gs.seg_body[gs.ss_pairs.ravel()])
        if gs.sb_pairs.size:
            touched.append(gs.seg_body[gs.sb_pairs[:, 0]])
            touched.append(gs.box_body[gs.sb_pairs[:, 1]])
        if gs.bb_pairs.size:
            touched.append(gs.box_body[gs.bb_pairs.ravel()])
    if not touched:
        return np.zeros((0,), np.int64)
    return np.unique(np.concatenate(touched)).astype(np.int64)


# --------------------------------------------------------------- host tables


def parse_geoms(mjcf_path: str, body_names, masses,
                exclude_adjacent: bool = True,
                mesh_as_box: bool = True) -> GeomSet:
    """Collect ALL primitive collision geoms (sphere/capsule/cylinder/box)
    from an MJCF into a :class:`GeomSet` with all-pairs candidate tables
    (different bodies; optionally skipping parent-child pairs, which are
    articulation-constrained).

    ``mesh_as_box`` approximates mesh geoms by their STL AABB as an
    oriented box (``native.stl_aabb``).  ``contype``/``conaffinity`` are read
    from geom attributes only; MJCF ``<default>`` class inheritance is not
    resolved.
    """
    from add_gym_torch.physics.model import _parse_vec, _quat_wxyz_to_mat
    from add_gym_torch.native import stl_aabb

    tree = ET.parse(mjcf_path)
    name_to_idx = {n: i for i, n in enumerate(body_names)}
    compiler = tree.getroot().find("compiler")
    meshdir = os.path.join(
        os.path.dirname(os.path.abspath(mjcf_path)),
        compiler.attrib.get("meshdir", ".") if compiler is not None else ".",
    )

    seg_body, seg_p0, seg_p1, seg_r, seg_mask = [], [], [], [], []
    box_body, box_pos, box_rot, box_half, box_mask = [], [], [], [], []
    parent_of = {}

    def walk(el, parent_name):
        for child in el:
            if child.tag != "body":
                continue
            name = child.attrib.get("name", "")
            parent_of[name] = parent_name
            bi = name_to_idx.get(name)
            if bi is not None:
                for g in child.findall("geom"):
                    gtype = g.attrib.get("type", "sphere")
                    # MuJoCo collision filtering: a geom with contype ==
                    # conaffinity == 0 never collides
                    ct = int(g.attrib.get("contype", "1"))
                    ca = int(g.attrib.get("conaffinity", "1"))
                    if ct == 0 and ca == 0:
                        continue
                    pos = np.asarray(_parse_vec(g, "pos", [0, 0, 0]), np.float64)
                    R = _quat_wxyz_to_mat(_parse_vec(g, "quat", [1, 0, 0, 0]))
                    if gtype == "sphere":
                        r = float(_parse_vec(g, "size", [0.01])[0])
                        seg_body.append(bi)
                        seg_p0.append(pos)
                        seg_p1.append(pos)
                        seg_r.append(r)
                    elif gtype in ("capsule", "cylinder"):
                        r = float(_parse_vec(g, "size", [0.01, 0.01])[0])
                        if "fromto" in g.attrib:
                            ft = np.asarray(
                                [float(v) for v in g.attrib["fromto"].split()], np.float64,
                            )
                            a, b = ft[:3], ft[3:]
                        else:
                            hl = float(_parse_vec(g, "size", [0.01, 0.01])[1])
                            axis = R @ np.array([0.0, 0.0, 1.0])
                            a, b = pos - hl * axis, pos + hl * axis
                        seg_body.append(bi)
                        seg_p0.append(a)
                        seg_p1.append(b)
                        seg_r.append(r)
                    elif gtype == "box":
                        size = np.asarray(_parse_vec(g, "size", [0.01, 0.01, 0.01]), np.float64)
                        box_body.append(bi)
                        box_pos.append(pos)
                        box_rot.append(R)
                        box_half.append(size)
                    elif gtype == "mesh" and mesh_as_box:
                        lo, hi = stl_aabb(os.path.join(meshdir, g.attrib["mesh"] + ".STL"))
                        lo = np.asarray(lo, np.float64)
                        hi = np.asarray(hi, np.float64)
                        box_body.append(bi)
                        box_pos.append(pos + R @ (0.5 * (lo + hi)))
                        box_rot.append(R)
                        box_half.append(0.5 * (hi - lo))
                    # record collision masks for whichever list grew
                    while len(seg_mask) < len(seg_body):
                        seg_mask.append((ct, ca))
                    while len(box_mask) < len(box_body):
                        box_mask.append((ct, ca))
            walk(child, name)

    worldbody = tree.getroot().find("worldbody")
    if worldbody is not None:
        walk(worldbody, None)

    idx_to_name = {i: n for n, i in name_to_idx.items()}
    masses = np.asarray(masses, np.float64)

    def admissible(bi, bj, mi, mj):
        if bi == bj:
            return False
        # MuJoCo pair rule: (contype_i & conaffinity_j) | (contype_j &
        # conaffinity_i)
        if not ((mi[0] & mj[1]) or (mj[0] & mi[1])):
            return False
        if exclude_adjacent:
            ni, nj = idx_to_name[int(bi)], idx_to_name[int(bj)]
            if parent_of.get(ni) == nj or parent_of.get(nj) == ni:
                return False
        return True

    def pair_table(bodies_a, bodies_b, masks_a, masks_b, same: bool):
        pairs, stiff = [], []
        for i in range(len(bodies_a)):
            for j in range(i + 1 if same else 0, len(bodies_b)):
                bi, bj = bodies_a[i], bodies_b[j]
                if admissible(bi, bj, masks_a[i], masks_b[j]):
                    pairs.append((i, j))
                    stiff.append(min(masses[bi], masses[bj]))
        return (
            np.asarray(pairs, np.int32) if pairs else np.zeros((0, 2), np.int32),
            np.asarray(stiff, np.float32) if stiff else np.zeros((0,), np.float32),
        )

    ss_pairs, ss_mass = pair_table(seg_body, seg_body, seg_mask, seg_mask, same=True)
    sb_pairs, sb_mass = pair_table(seg_body, box_body, seg_mask, box_mask, same=False)
    bb_pairs, bb_mass = pair_table(box_body, box_body, box_mask, box_mask, same=True)

    def arr(x, shape, dt=np.float32):
        return np.asarray(x, dt) if len(x) else np.zeros(shape, dt)

    return GeomSet(
        seg_body=arr(seg_body, (0,), np.int32),
        seg_p0=arr(seg_p0, (0, 3)),
        seg_p1=arr(seg_p1, (0, 3)),
        seg_radius=arr(seg_r, (0,)),
        box_body=arr(box_body, (0,), np.int32),
        box_pos=arr(box_pos, (0, 3)),
        box_rot=arr(box_rot, (0, 3, 3)),
        box_half=arr(box_half, (0, 3)),
        ss_pairs=ss_pairs, ss_mass=ss_mass,
        sb_pairs=sb_pairs, sb_mass=sb_mass,
        bb_pairs=bb_pairs, bb_mass=bb_mass,
    )


def rest_pose_prune(gs: GeomSet, parent, local_pos, local_quat,
                    margin: float = 0.03) -> GeomSet:
    """Drop candidate pairs already proximate at the zero pose.

    Boxes of neighbouring links overlap at rest; keeping those pairs would
    make the robot permanently fight its own stance.  Pairs closer than
    ``margin`` (in surface distance) at the rest pose are removed.  The
    rest-pose frames are float64; each distance query runs in f32 on CPU
    tensors, and its result is compared as the JAX package compares it.
    """
    from add_gym_torch.physics.model import _quat_wxyz_to_mat

    nb = len(parent)
    pos = np.zeros((nb, 3))
    rot = np.zeros((nb, 3, 3))
    rot[0] = np.eye(3)
    for i in range(1, nb):
        p = int(parent[i])
        rot[i] = rot[p] @ _quat_wxyz_to_mat(np.asarray(local_quat[i], np.float64))
        pos[i] = pos[p] + rot[p] @ np.asarray(local_pos[i], np.float64)

    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)

    def seg_world(i):
        b = int(gs.seg_body[i])
        return (pos[b] + rot[b] @ gs.seg_p0[i], pos[b] + rot[b] @ gs.seg_p1[i])

    def box_world(i):
        b = int(gs.box_body[i])
        return (pos[b] + rot[b] @ gs.box_pos[i], rot[b] @ gs.box_rot[i])

    keep_ss = []
    for k, (i, j) in enumerate(np.asarray(gs.ss_pairs).reshape(-1, 2)):
        a0, a1 = seg_world(i)
        b0, b1 = seg_world(j)
        pa, pb = segment_closest_points(f32(a0), f32(a1), f32(b0), f32(b1))
        dist = float(np.linalg.norm((pa - pb).numpy()))
        if dist - (gs.seg_radius[i] + gs.seg_radius[j]) >= margin:
            keep_ss.append(k)

    keep_sb = []
    for k, (i, j) in enumerate(np.asarray(gs.sb_pairs).reshape(-1, 2)):
        a0, a1 = seg_world(i)
        c, Rw = box_world(j)
        al = Rw.T @ (a0 - c)
        bl = Rw.T @ (a1 - c)
        _, _, _, sd = segment_box_closest(f32(al), f32(bl), f32(gs.box_half[j]))
        if float(sd) - gs.seg_radius[i] >= margin:
            keep_sb.append(k)

    corners = _CORNERS.astype(np.float64)

    def box_pair_min_sd(i, j):
        ci, Ri = box_world(i)
        cj, Rj = box_world(j)
        m = np.inf
        for (src_c, src_R, src_h, dst_c, dst_R, dst_h) in (
            (ci, Ri, gs.box_half[i], cj, Rj, gs.box_half[j]),
            (cj, Rj, gs.box_half[j], ci, Ri, gs.box_half[i]),
        ):
            vw = src_c[None] + (corners * src_h[None]) @ src_R.T
            vl = (vw - dst_c[None]) @ dst_R
            _, _, sd = box_surface_point(f32(vl), f32(dst_h))
            m = min(m, float(np.min(sd.numpy())))
        return m

    keep_bb = []
    for k, (i, j) in enumerate(np.asarray(gs.bb_pairs).reshape(-1, 2)):
        if box_pair_min_sd(int(i), int(j)) >= margin:
            keep_bb.append(k)

    def take(arr, idx):
        idx = np.asarray(idx, np.int32)
        return arr[idx] if len(idx) else arr[:0]

    return dataclasses.replace(
        gs,
        ss_pairs=take(gs.ss_pairs, keep_ss), ss_mass=take(gs.ss_mass, keep_ss),
        sb_pairs=take(gs.sb_pairs, keep_sb), sb_mass=take(gs.sb_mass, keep_sb),
        bb_pairs=take(gs.bb_pairs, keep_bb), bb_mass=take(gs.bb_mass, keep_bb),
    )


def parse_capsules(mjcf_path: str, body_names, masses,
                   exclude_adjacent: bool = True) -> CapsuleSet:
    """Collect capsule/cylinder collision geoms from an MJCF file and build
    an all-pairs candidate table (different bodies; optionally skipping
    parent-child pairs, which are articulation-constrained).

    ``body_names`` fixes the body index order (the PhysicsModel BFS order);
    ``masses`` [nb] feed the per-pair contact stiffness (min of the pair).
    """
    from add_gym_torch.physics.model import _parse_vec, _quat_wxyz_to_mat

    tree = ET.parse(mjcf_path)
    name_to_idx = {n: i for i, n in enumerate(body_names)}

    body, p0, p1, radius = [], [], [], []
    parent_of = {}

    def walk(el, parent_name):
        for child in el:
            if child.tag != "body":
                continue
            name = child.attrib.get("name", "")
            parent_of[name] = parent_name
            bi = name_to_idx.get(name)
            if bi is not None:
                for g in child.findall("geom"):
                    gtype = g.attrib.get("type", "sphere")
                    if gtype not in ("capsule", "cylinder"):
                        continue
                    size = _parse_vec(g, "size", [0.01, 0.01])
                    r, hl = float(size[0]), float(size[1])
                    pos = np.asarray(_parse_vec(g, "pos", [0, 0, 0]), np.float64)
                    R = _quat_wxyz_to_mat(_parse_vec(g, "quat", [1, 0, 0, 0]))
                    axis = R @ np.array([0.0, 0.0, 1.0])
                    body.append(bi)
                    p0.append(pos - hl * axis)
                    p1.append(pos + hl * axis)
                    radius.append(r)
            walk(child, name)

    worldbody = tree.getroot().find("worldbody")
    if worldbody is not None:
        walk(worldbody, None)

    body_np = np.asarray(body, np.int32)
    pairs = []
    idx_to_name = {i: n for n, i in name_to_idx.items()}
    for i in range(len(body)):
        for j in range(i + 1, len(body)):
            bi, bj = body_np[i], body_np[j]
            if bi == bj:
                continue
            if exclude_adjacent:
                ni, nj = idx_to_name[int(bi)], idx_to_name[int(bj)]
                if parent_of.get(ni) == nj or parent_of.get(nj) == ni:
                    continue
            pairs.append((i, j))
    pairs_np = np.asarray(pairs, np.int32) if pairs else np.zeros((0, 2), np.int32)
    masses = np.asarray(masses, np.float64)
    stiff = (
        np.minimum(masses[body_np[pairs_np[:, 0]]],
                   masses[body_np[pairs_np[:, 1]]]).astype(np.float32)
        if pairs_np.size else np.zeros((0,), np.float32)
    )
    return CapsuleSet(
        body=body_np,
        p0=np.asarray(p0, np.float32) if p0 else np.zeros((0, 3), np.float32),
        p1=np.asarray(p1, np.float32) if p1 else np.zeros((0, 3), np.float32),
        radius=np.asarray(radius, np.float32) if radius else np.zeros((0,), np.float32),
        pairs=pairs_np,
        stiff_mass=stiff,
    )
