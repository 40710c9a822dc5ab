"""Physics model: full MJCF parse into static host arrays for the engine.

Counterpart of ``add_gym_tpu/physics/model.py``: a single fixed articulated
topology (free base + hinge joints) parsed into constant numpy arrays that
the control step (``fused_step`` / ``cuda_step``) reads.

Collision handling is point-based: every collidable geom contributes a
small set of contact points (explicit sphere geoms as-is; cylinder and
capsule ends; box corners; mesh AABB corners from the STL), tested against
the ground plane.  Self-collision uses spheres fitted to the collision AABB
of curated body groups.  The optional narrowphase tables
(:func:`attach_capsules` / :func:`attach_geoms`, ``physics/narrowphase.py``)
widen contacts to capsule pairs or to all collision primitives.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List

import numpy as np

from port_bench.reference.kinematics.char_model import CharModel, JointType, load_char_model


@dataclass(frozen=True)
class PhysicsModel:
    """Static physical description of the robot in BFS body order.

    All quaternions wxyz.  ``nb`` bodies, ``nd`` actuated dofs (hinges),
    ``np`` contact points.  The free base contributes 6 velocity dofs that
    are tracked separately in the state (not part of nd).
    """

    # topology (mirrors CharModel ordering)
    parent: np.ndarray        # [nb]
    local_pos: np.ndarray     # [nb, 3]
    local_quat: np.ndarray    # [nb, 4] wxyz
    joint_axis: np.ndarray    # [nb, 3]

    # inertial (body frame)
    mass: np.ndarray          # [nb]
    com: np.ndarray           # [nb, 3]
    inertia: np.ndarray       # [nb, 3, 3] about COM

    # per-dof joint parameters (hinges only, dof i belongs to body i+1)
    dof_limit: np.ndarray     # [nd, 2]
    dof_damping: np.ndarray   # [nd]
    dof_armature: np.ndarray  # [nd]
    dof_friction: np.ndarray  # [nd]
    dof_force_range: np.ndarray  # [nd, 2]

    # contact points
    cp_body: np.ndarray       # [np] body index
    cp_pos: np.ndarray        # [np, 3] body frame
    cp_radius: np.ndarray     # [np]
    cp_mass: np.ndarray       # [np] load-scaled effective mass (stiffness)
    cp_mass_local: np.ndarray  # [np] local body mass share (impulse clamps)
    cp_mass_stab: np.ndarray  # [np] rotation-aware stability mass (spring cap)
    cp_explicit: np.ndarray   # [np] bool: designed load-bearing point

    # AABB of all collidable geometry per body (body frame), for init height
    body_aabb: np.ndarray     # [nb, 2, 3]

    # self-collision spheres + tested sphere pairs (possibly empty)
    sc_body: np.ndarray       # [S] body index
    sc_pos: np.ndarray        # [S, 3] body frame
    sc_radius: np.ndarray     # [S]
    sc_pairs: np.ndarray      # [Q, 2] sphere indices
    sc_stiff_mass: np.ndarray  # [Q] pair effective mass (contact rates)

    body_names: list
    joint_names: list  # [nd] MJCF joint names (hinges, BFS order)

    # optional capsule-capsule narrowphase pair table (physics/narrowphase
    # .py), evaluated by the reference-layout engine; opt in with
    # attach_capsules()
    capsules: object = None
    # optional general geom-geom narrowphase tables (sphere/capsule/
    # cylinder/box; narrowphase.GeomSet), held per control step on every
    # backend; opt in with attach_geoms() (supersedes ``capsules``: do not
    # attach both)
    geoms: object = None

    @property
    def nb(self) -> int:
        return len(self.body_names)

    @property
    def nd(self) -> int:
        return self.dof_limit.shape[0]

    @property
    def ncp(self) -> int:
        return self.cp_body.shape[0]


def _parse_vec(node, attr, default):
    d = node.attrib.get(attr)
    if d is None:
        return np.asarray(default, dtype=np.float64)
    return np.array(d.split(), dtype=np.float64)


def _resolve_default_joint_params(root_el):
    """Collect per-class joint defaults (damping/armature/frictionloss)."""
    out = {}

    def walk(node, inherited):
        params = dict(inherited)
        j = node.find("joint")
        if j is not None:
            for k in ("damping", "armature", "frictionloss"):
                if k in j.attrib:
                    params[k] = float(j.attrib[k])
        cls = node.attrib.get("class")
        if cls:
            out[cls] = params
        for child in node.findall("default"):
            walk(child, params)

    top = root_el.find("default")
    if top is not None:
        walk(top, {})
        out[None] = {}
    return out


def _quat_wxyz_to_mat(q):
    w, x, y, z = q
    n = (q * q).sum()
    s = 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def _geom_contact_points(geom, meshdir):
    """Contact points (pos[body frame], radius) for one collidable geom."""
    gtype = geom.attrib.get("type", "sphere")
    pos = _parse_vec(geom, "pos", [0, 0, 0])
    quat = _parse_vec(geom, "quat", [1, 0, 0, 0])
    R = _quat_wxyz_to_mat(quat)

    if gtype == "sphere":
        # explicit sphere geoms are designed load-bearing contacts (the G1
        # foot pads) — marked explicit=True for stiffer contact handling
        size = _parse_vec(geom, "size", [0.01])
        return [(pos, float(size[0]), True)]

    if gtype == "cylinder":
        size = _parse_vec(geom, "size", [0.01, 0.01])
        r, hl = float(size[0]), float(size[1])
        pts = []
        for sz in (-hl, hl):
            pts.append((pos + R @ np.array([0.0, 0.0, sz]), r, False))
        return pts

    if gtype == "capsule":
        size = _parse_vec(geom, "size", [0.01, 0.01])
        r, hl = float(size[0]), float(size[1])
        return [(pos + R @ np.array([0.0, 0.0, sz]), r, False) for sz in (-hl, hl)]

    if gtype == "box":
        size = _parse_vec(geom, "size", [0.01, 0.01, 0.01])
        pts = []
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    corner = size * np.array([sx, sy, sz])
                    pts.append((pos + R @ corner, 0.0, False))
        return pts

    if gtype == "mesh":
        mesh_file = os.path.join(meshdir, geom.attrib["mesh"] + ".STL")
        raise NotImplementedError(f"the reference reads no mesh geoms: {mesh_file}")
        pts = []
        for sx in (lo[0], hi[0]):
            for sy in (lo[1], hi[1]):
                for sz in (lo[2], hi[2]):
                    corner = np.array([sx, sy, sz])
                    pts.append((pos + R @ corner, 0.0, False))
        return pts

    raise ValueError(f"Unsupported geom type: {gtype}")


def build_physics_model(mjcf_path: str, char: CharModel | None = None) -> PhysicsModel:
    """Build the PhysicsModel from an MJCF file (BFS body order)."""
    if char is None:
        char = load_char_model(mjcf_path)

    tree = ET.parse(mjcf_path)
    root_el = tree.getroot()
    compiler = root_el.find("compiler")
    meshdir = os.path.join(
        os.path.dirname(mjcf_path),
        compiler.attrib.get("meshdir", ".") if compiler is not None else ".",
    )
    # mesh name -> file stem mapping (assets may rename)
    mesh_files = {}
    asset = root_el.find("asset")
    if asset is not None:
        for m in asset.findall("mesh"):
            mesh_files[m.attrib["name"]] = m.attrib.get("file", m.attrib["name"] + ".STL")

    joint_defaults = _resolve_default_joint_params(root_el)

    # index XML body nodes by name
    xml_bodies = {b.attrib["name"]: b for b in root_el.iter("body")}

    nb = char.num_bodies
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    dof_limit, dof_damping, dof_armature, dof_friction, dof_frange = [], [], [], [], []
    cp_body: List[int] = []
    cp_pos: List[np.ndarray] = []
    cp_radius: List[float] = []
    cp_explicit: List[bool] = []
    body_aabb = np.zeros((nb, 2, 3))

    for i, name in enumerate(char.body_names):
        body = xml_bodies[name]

        inert = body.find("inertial")
        if inert is None:
            raise ValueError(f"body {name} missing <inertial>")
        mass[i] = float(inert.attrib["mass"])
        com[i] = _parse_vec(inert, "pos", [0, 0, 0])
        diag = _parse_vec(inert, "diaginertia", [0, 0, 0])
        iq = _parse_vec(inert, "quat", [1, 0, 0, 0])
        R = _quat_wxyz_to_mat(iq)
        inertia[i] = R @ np.diag(diag) @ R.T

        if i > 0:
            jt = JointType(int(char.joint_types[i]))
            if jt == JointType.HINGE:
                j = body.find("joint")
                cls = j.attrib.get("class")
                dflt = joint_defaults.get(cls, {})
                rng = _parse_vec(j, "range", [-1e9, 1e9])
                dof_limit.append(rng)
                dof_damping.append(float(j.attrib.get("damping", dflt.get("damping", 0.0))))
                dof_armature.append(float(j.attrib.get("armature", dflt.get("armature", 0.0))))
                dof_friction.append(
                    float(j.attrib.get("frictionloss", dflt.get("frictionloss", 0.0)))
                )
                frange = _parse_vec(j, "actuatorfrcrange", [-1e9, 1e9])
                dof_frange.append(frange)
            else:
                if jt != JointType.FIXED:
                    raise ValueError("only hinge/fixed joints supported")

        # collidable geoms: contype != 0 (MuJoCo default contype is 1)
        pts = []
        for geom in body.findall("geom"):
            if geom.attrib.get("contype") == "0":
                continue
            if geom.attrib.get("type") == "mesh":
                stem = mesh_files.get(geom.attrib["mesh"])
                if stem is not None:
                    geom = _with_mesh_file(geom, stem)
            pts.extend(_geom_contact_points(geom, meshdir))
        if pts:
            pos_arr = np.stack([p for p, _, _ in pts])
            rad_arr = np.array([r for _, r, _ in pts])
            lo = (pos_arr - rad_arr[:, None]).min(axis=0)
            hi = (pos_arr + rad_arr[:, None]).max(axis=0)
            body_aabb[i] = np.stack([lo, hi])
            for p, r, ex in pts:
                cp_body.append(i)
                cp_pos.append(p)
                cp_radius.append(r)
                cp_explicit.append(ex)
        else:
            body_aabb[i] = 0.0

    cp_body_arr = np.asarray(cp_body, np.int32)
    counts = np.bincount(cp_body_arr, minlength=nb)
    # Effective mass per contact point sets the contact spring scale.  A
    # standing robot loads its foot points with the *total* mass, not the
    # foot link's, so scale by total mass over a typical stance point count
    # (two feet x 4 pads, mirroring the MJCF foot spheres) with the body's
    # own share as a lower bound.
    cp_mass = np.maximum(
        mass.sum() / 16.0,
        mass[cp_body_arr] / np.maximum(counts[cp_body_arr], 1),
    )
    # Local effective mass (the body's own share) bounds damping/friction
    # impulses for stability on light limbs.
    cp_mass_local = np.maximum(
        mass[cp_body_arr] / np.maximum(counts[cp_body_arr], 1), 1e-3
    )
    # Rotation-aware stability mass: the effective mass a point force "sees"
    # on its own body, including the rotational lever (1/m_eff = 1/m +
    # r^2/I_min), shared across the body's points.  Used to cap spring rates
    # on auto-generated (AABB/cylinder) points so deep slams on light,
    # thin links cannot ratchet energy under explicit integration.
    cp_pos_arr = np.asarray(cp_pos)
    r_lever = np.linalg.norm(cp_pos_arr - com[cp_body_arr], axis=-1)
    i_min = np.array([np.linalg.eigvalsh(inertia[b]).min() for b in range(nb)])
    inv_meff = 1.0 / np.maximum(mass[cp_body_arr], 1e-6) + (
        r_lever**2 / np.maximum(i_min[cp_body_arr], 1e-8)
    )
    cp_mass_stab = np.maximum(
        1.0 / (inv_meff * np.maximum(counts[cp_body_arr], 1)), 1e-4
    )

    sc_body, sc_pos, sc_radius, sc_pairs, sc_stiff = _build_self_collision(
        char, char.body_names, body_aabb, mass
    )

    f32 = lambda x: np.asarray(x, np.float32)
    return PhysicsModel(
        parent=char.parent_indices.copy(),
        local_pos=f32(char.local_translation),
        local_quat=f32(char.local_rotation_wxyz()),
        joint_axis=f32(char.joint_axes),
        mass=f32(mass),
        com=f32(com),
        inertia=f32(inertia),
        dof_limit=f32(dof_limit),
        dof_damping=f32(dof_damping),
        dof_armature=f32(dof_armature),
        dof_friction=f32(dof_friction),
        dof_force_range=f32(dof_frange),
        cp_body=cp_body_arr,
        cp_pos=f32(cp_pos),
        cp_radius=f32(cp_radius),
        cp_mass=f32(cp_mass),
        cp_mass_local=f32(cp_mass_local),
        cp_mass_stab=f32(cp_mass_stab),
        cp_explicit=np.asarray(cp_explicit, bool),
        body_aabb=f32(body_aabb),
        sc_body=sc_body,
        sc_pos=sc_pos,
        sc_radius=sc_radius,
        sc_pairs=sc_pairs,
        sc_stiff_mass=sc_stiff,
        body_names=list(char.body_names),
        joint_names=[char.joint_names[i] for i in range(1, nb)],
    )


# body groups tested for self-collision (reference enables full self-
# collision in the engine, envs/env.py:66-72; here: the pairs that matter
# for humanoid motion — crossing legs, arms vs torso/legs, arm vs arm),
# auto-pruned of pairs already proximate in the default standing pose
_SC_GROUPS = {
    "thigh": r".*hip_yaw_link",
    "shin": r".*knee_link",
    "foot": r".*ankle_roll_link",
    "torso": r"torso_link",
    "pelvis": r"pelvis",
    "forearm": r".*elbow_link",
    "hand": r".*wrist_pitch_link",
}
_SC_PAIR_GROUPS = [
    # left/right leg crossings
    ("thigh", "thigh"), ("thigh", "shin"), ("thigh", "foot"),
    ("shin", "shin"), ("shin", "foot"), ("foot", "foot"),
    # arms vs trunk and legs
    ("forearm", "torso"), ("forearm", "pelvis"), ("forearm", "thigh"),
    ("hand", "torso"), ("hand", "pelvis"), ("hand", "thigh"),
    ("hand", "shin"),
    # arm vs arm
    ("forearm", "forearm"), ("hand", "hand"), ("forearm", "hand"),
]


def _rest_pose_fk(char: CharModel):
    """World body positions/rotations at the zero pose (host numpy)."""
    nb = char.num_bodies
    pos = np.zeros((nb, 3))
    rot = np.zeros((nb, 3, 3))
    rot[0] = np.eye(3)
    lq = char.local_rotation_wxyz()
    for i in range(1, nb):
        p = int(char.parent_indices[i])
        L = _quat_wxyz_to_mat(np.asarray(lq[i], np.float64))
        rot[i] = rot[p] @ L
        pos[i] = pos[p] + rot[p] @ np.asarray(char.local_translation[i], np.float64)
    return pos, rot


def _build_self_collision(char: CharModel, body_names, body_aabb, mass):
    """Spheres per grouped body (from its collision AABB) + tested pairs."""
    import re

    group_bodies = {
        g: [i for i, n in enumerate(body_names) if re.fullmatch(pat, n)]
        for g, pat in _SC_GROUPS.items()
    }

    sc_body, sc_pos, sc_radius = [], [], []
    body_spheres = {}
    for g, bodies in group_bodies.items():
        for b in bodies:
            lo, hi = body_aabb[b]
            ext = hi - lo
            if not ext.any():
                continue
            center = 0.5 * (lo + hi)
            order = np.argsort(ext)
            long_ax, mid_e, min_e = order[-1], ext[order[1]], ext[order[0]]
            radius = max(0.25 * (mid_e + min_e), 0.02)
            offs = [0.0]
            if ext[long_ax] > 1.8 * mid_e:
                d = max(0.5 * ext[long_ax] - radius, 0.0)
                offs = [-d, d]
            ids = []
            for off in offs:
                p = center.copy()
                p[long_ax] += off
                ids.append(len(sc_body))
                sc_body.append(b)
                sc_pos.append(p)
                sc_radius.append(radius)
            body_spheres[b] = ids

    # candidate sphere pairs from the group pairs (skip same body / parents)
    pairs = set()
    parent = char.parent_indices
    for ga, gb in _SC_PAIR_GROUPS:
        for ba in group_bodies[ga]:
            for bb in group_bodies[gb]:
                if ba == bb or parent[ba] == bb or parent[bb] == ba:
                    continue
                if ba not in body_spheres or bb not in body_spheres:
                    continue
                for sa in body_spheres[ba]:
                    for sb in body_spheres[bb]:
                        pairs.add((min(sa, sb), max(sa, sb)))

    # prune pairs already proximate in the rest pose (margin 3 cm): they
    # would fire constantly and fight the default stance
    sc_pos_np = np.asarray(sc_pos) if sc_pos else np.zeros((0, 3))
    sc_body_np = np.asarray(sc_body, np.int32)
    sc_radius_np = np.asarray(sc_radius) if sc_radius else np.zeros((0,))
    pos_w, rot_w = _rest_pose_fk(char)
    world = np.array(
        [pos_w[b] + rot_w[b] @ p for b, p in zip(sc_body_np, sc_pos_np)]
    ) if len(sc_body_np) else np.zeros((0, 3))

    kept, stiff = [], []
    for sa, sb in sorted(pairs):
        dist = np.linalg.norm(world[sa] - world[sb])
        if dist < sc_radius_np[sa] + sc_radius_np[sb] + 0.03:
            continue
        kept.append((sa, sb))
        ma, mb = mass[sc_body_np[sa]], mass[sc_body_np[sb]]
        stiff.append(1.0 / (1.0 / max(ma, 1e-3) + 1.0 / max(mb, 1e-3)))

    return (
        sc_body_np,
        sc_pos_np.astype(np.float32),
        sc_radius_np.astype(np.float32),
        np.asarray(kept, np.int32).reshape(-1, 2),
        np.asarray(stiff, np.float32),
    )


def _with_mesh_file(geom, file_stem):
    """Return a shallow geom proxy whose mesh attribute is the file stem."""
    import copy

    g = copy.copy(geom)
    g.attrib = dict(geom.attrib)
    g.attrib["mesh"] = os.path.splitext(file_stem)[0]
    return g
