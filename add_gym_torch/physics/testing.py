"""Test fixtures for the physics and the whole slice: MJCF and clip writers.

* ``MINI_MJCF``: the 3-body / 2-dof "mini biped" of the JAX package (free
  pelvis + one hinge leg per side, sphere collision geoms).
* :func:`g1_fixture_mjcf`: a **G1-shaped** robot.  It has the Unitree G1's
  30 bodies and 29 hinges, named as the G1's MJCF names them, in the same
  tree (two 6-dof legs, a 3-dof waist, two 7-dof arms), with link offsets,
  joint axes, joint ranges and masses close to the G1's.  Every link has
  one collidable box whose 8 corners stand in for the G1's mesh AABB
  corners, and each foot carries four explicit sphere pads.  It exists
  because the G1's own description files are data assets this repository
  does not ship; both packages load it by absolute path, so one file
  drives the JAX reference and the port at the G1's widths.
* :func:`write_wide_fixture`: the G1-shaped robot with extra hinged
  links at the wrists (32 bodies at 2 extra: the kernel's narrow
  instance's most; 49 at 19, past its wide instance's 48).
* :func:`write_mesh_fixture`: the G1-shaped robot with one binary-STL box
  per body as a visual mesh geom (``group="1"``, not collidable), for the
  renderer: the physics model built from it is the plain fixture's.
* :func:`write_motion_csv`: a synthetic ``.motion`` clip (36 columns:
  root pos, root quat xyzw at columns 3-6, 29 joint angles; 30 fps) made
  from a numpy seed.
* :func:`write_motion_pickle`: the same frames as a pickle clip, which
  carries a loop mode (WRAP clips exist only in that format).
* :func:`slice_config`: a top-level config on the G1-shaped fixture and a
  synthetic 300-frame clip, as the bench, the profiler and the smoke run
  it: the G1's own assets are not in the repository.

Every writer replaces its file in one rename, so processes that write the
same fixture side by side never read a half-written one.
"""

from __future__ import annotations

import os
import pickle
import re
import struct

import numpy as np

from add_gym_torch.utils.config import load_config

MINI_MJCF = """<mujoco model="mini_biped">
  <compiler angle="radian" />
  <default>
    <default class="leg_motor">
      <joint damping="0.05" armature="0.01" frictionloss="0.1"/>
    </default>
  </default>
  <worldbody>
    <body name="pelvis" pos="0 0 0.6">
      <inertial pos="0 0 0" mass="4.0" diaginertia="0.02 0.02 0.01" />
      <joint name="floating_base_joint" type="free" limited="false" />
      <geom type="sphere" size="0.08" pos="0 0 0" />
      <body name="left_leg_link" pos="0 0.1 -0.1">
        <inertial pos="0 0 -0.25" mass="1.5" diaginertia="0.01 0.01 0.002" />
        <joint name="left_leg_joint" type="hinge" range="-1.5 1.5"
               axis="0 1 0" class="leg_motor" />
        <geom type="sphere" size="0.05" pos="0 0 -0.5" />
      </body>
      <body name="right_leg_link" pos="0 -0.1 -0.1">
        <inertial pos="0 0 -0.25" mass="1.5" diaginertia="0.01 0.01 0.002" />
        <joint name="right_leg_joint" type="hinge" range="-1.5 1.5"
               axis="0 1 0" class="leg_motor" />
        <geom type="sphere" size="0.05" pos="0 0 -0.5" />
      </body>
    </body>
  </worldbody>
</mujoco>
"""

# the motion files store joints in this fixed order (G1 motion_joint_order)
MOTION_JOINT_ORDER = [
    "left_hip_pitch_joint", "left_hip_roll_joint", "left_hip_yaw_joint",
    "left_knee_joint", "left_ankle_pitch_joint", "left_ankle_roll_joint",
    "right_hip_pitch_joint", "right_hip_roll_joint", "right_hip_yaw_joint",
    "right_knee_joint", "right_ankle_pitch_joint", "right_ankle_roll_joint",
    "waist_yaw_joint", "waist_roll_joint", "waist_pitch_joint",
    "left_shoulder_pitch_joint", "left_shoulder_roll_joint",
    "left_shoulder_yaw_joint", "left_elbow_joint",
    "left_wrist_roll_joint", "left_wrist_pitch_joint", "left_wrist_yaw_joint",
    "right_shoulder_pitch_joint", "right_shoulder_roll_joint",
    "right_shoulder_yaw_joint", "right_elbow_joint",
    "right_wrist_roll_joint", "right_wrist_pitch_joint", "right_wrist_yaw_joint",
]

G1_PELVIS_HEIGHT = 0.793

_X, _Y, _Z = "1 0 0", "0 1 0", "0 0 1"

# (link, joint axis, joint range, pos in parent, mass, box center, box
#  half-size, joint default class); leg and arm links get a left_/right_
#  prefix, and the right side mirrors y
_LEG = [
    ("hip_pitch", _Y, (-2.5307, 2.8798), (0, 0.064452, -0.1027), 1.35,
     (0.0, 0.04, -0.03), (0.04, 0.035, 0.045), "leg"),
    ("hip_roll", _X, (-0.5236, 2.9671), (0, 0.052, -0.030465), 1.52,
     (0.02, 0.0, -0.06), (0.045, 0.04, 0.05), "leg"),
    ("hip_yaw", _Z, (-2.7576, 2.7576), (0.025001, 0, -0.12412), 1.70,
     (-0.03, 0.0, -0.09), (0.05, 0.05, 0.1), "leg"),
    ("knee", _Y, (-0.087267, 2.8798), (-0.078273, 0.0021489, -0.17734), 1.97,
     (0.0, 0.0, -0.15), (0.045, 0.045, 0.14), "leg"),
    ("ankle_pitch", _Y, (-0.87267, 0.5236), (0, -9.4445e-05, -0.30001), 0.074,
     (0.0, 0.0, -0.008), (0.015, 0.015, 0.01), "foot"),
    ("ankle_roll", _X, (-0.2618, 0.2618), (0, 0, -0.017558), 0.61,
     (0.035, 0.0, -0.022), (0.1, 0.035, 0.018), "foot"),
]
_ROLL_RANGE_RIGHT = (-2.9671, 0.5236)
_WAIST = [
    ("waist_yaw", _Z, (-2.618, 2.618), (0, 0, 0), 0.21,
     (0.0, 0.0, 0.02), (0.03, 0.03, 0.02), "waist"),
    ("waist_roll", _X, (-0.52, 0.52), (-0.0039635, 0, 0.035), 0.086,
     (0.0, 0.0, 0.01), (0.02, 0.03, 0.01), "waist"),
    ("torso", _Y, (-0.52, 0.52), (0, 0, 0.019), 7.8,
     (0.0, 0.0, 0.2), (0.08, 0.11, 0.18), "waist"),
]
_ARM = [
    ("shoulder_pitch", _Y, (-3.0892, 2.6704), (0.0039563, 0.10022, 0.24778), 0.71,
     (0.0, 0.03, -0.01), (0.035, 0.035, 0.035), "arm"),
    ("shoulder_roll", _X, (-1.5882, 2.2515), (0, 0.038, -0.013831), 0.64,
     (0.0, 0.0, -0.05), (0.03, 0.03, 0.05), "arm"),
    ("shoulder_yaw", _Z, (-2.618, 2.618), (0, 0.00624, -0.1032), 0.73,
     (0.0, 0.0, -0.04), (0.03, 0.03, 0.045), "arm"),
    ("elbow", _Y, (-1.0472, 2.0944), (0.015783, 0, -0.080518), 0.60,
     (0.05, 0.0, -0.005), (0.06, 0.025, 0.025), "arm"),
    ("wrist_roll", _X, (-1.972222, 1.972222), (0.1, 0.00188791, -0.01), 0.085,
     (0.02, 0.0, 0.0), (0.02, 0.02, 0.02), "arm"),
    ("wrist_pitch", _Y, (-1.614429, 1.614429), (0.038, 0, 0), 0.48,
     (0.025, 0.0, 0.0), (0.025, 0.025, 0.025), "arm"),
    ("wrist_yaw", _Z, (-1.614429, 1.614429), (0.046, 0, 0), 0.25,
     (0.05, 0.0, 0.0), (0.05, 0.025, 0.03), "arm"),
]
_ARM_ROLL_RANGE_RIGHT = (-2.2515, 1.5882)


def _fmt(v):
    return " ".join(f"{float(x):.6g}" for x in v)


def _box_inertia(mass, half):
    a, b, c = (2.0 * h for h in half)
    return (mass / 12.0 * (b * b + c * c), mass / 12.0 * (a * a + c * c),
            mass / 12.0 * (a * a + b * b))


def _link_xml(side, spec, indent, inner, right):
    name, axis, rng, pos, mass, center, half, cls = spec
    if right:
        pos = (pos[0], -pos[1], pos[2])
        center = (center[0], -center[1], center[2])
    full = f"{side}_{name}" if side else name
    body = f"{full}_link"
    joint = f"{full}_joint" if name != "torso" else "waist_pitch_joint"
    ind = " " * indent
    lines = [
        f'{ind}<body name="{body}" pos="{_fmt(pos)}">',
        f'{ind}  <inertial pos="{_fmt(center)}" mass="{mass}" '
        f'diaginertia="{_fmt(_box_inertia(mass, half))}"/>',
        f'{ind}  <joint name="{joint}" axis="{axis}" range="{_fmt(rng)}" class="{cls}"/>',
        f'{ind}  <geom type="box" pos="{_fmt(center)}" size="{_fmt(half)}"/>',
    ]
    if name == "ankle_roll":
        # explicit load-bearing foot pads at the sole corners
        for sx in (-0.065, 0.125):
            for sy in (-0.025, 0.025):
                lines.append(
                    f'{ind}  <geom type="sphere" size="0.005" pos="{_fmt((sx, sy, -0.035))}"/>'
                )
    lines.append(inner)
    lines.append(f"{ind}</body>")
    return "\n".join(line for line in lines if line)


def _chain(side, specs, indent, right, overrides):
    inner = ""
    for depth in range(len(specs) - 1, -1, -1):
        spec = specs[depth]
        if right and spec[0] in overrides:
            spec = spec[:2] + (overrides[spec[0]],) + spec[3:]
        inner = _link_xml(side, spec, indent + 2 * depth, inner, right)
    return inner


def g1_fixture_mjcf() -> str:
    """MJCF text of the G1-shaped fixture (30 bodies, 29 hinges)."""
    arms = "\n".join(
        _chain(side, _ARM, 10, side == "right", {"shoulder_roll": _ARM_ROLL_RANGE_RIGHT})
        for side in ("left", "right")
    )
    # torso holds both arms: splice them into the torso body
    waist = _chain("", _WAIST, 6, False, {})
    torso_close = " " * 10 + "</body>"
    waist = waist.replace(torso_close, arms + "\n" + torso_close, 1)
    legs = "\n".join(
        _chain(side, _LEG, 6, side == "right", {"hip_roll": _ROLL_RANGE_RIGHT})
        for side in ("left", "right")
    )
    return f"""<mujoco model="g1_shaped_fixture">
  <compiler angle="radian"/>
  <default>
    <default class="leg">
      <joint damping="0.05" armature="0.025" frictionloss="0.2"/>
    </default>
    <default class="foot">
      <joint damping="0.05" armature="0.01" frictionloss="0.2"/>
    </default>
    <default class="waist">
      <joint damping="0.05" armature="0.025" frictionloss="0.1"/>
    </default>
    <default class="arm">
      <joint damping="0.05" armature="0.01" frictionloss="0.1"/>
    </default>
  </default>
  <worldbody>
    <body name="pelvis" pos="0 0 {G1_PELVIS_HEIGHT}">
      <inertial pos="0 0 -0.07" mass="3.81" diaginertia="{_fmt(_box_inertia(3.81, (0.07, 0.1, 0.06)))}"/>
      <freejoint name="floating_base_joint"/>
      <geom type="box" pos="0 0 -0.05" size="0.07 0.1 0.06"/>
{legs}
{waist}
    </body>
  </worldbody>
</mujoco>
"""


def _replace(path: str, write) -> str:
    """``write(f)`` into a temporary file beside ``path``, then rename it
    over ``path``; returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)
    return path


def _write(path: str, text: str) -> str:
    return _replace(path, lambda f: f.write(text.encode()))


def write_mini_mjcf(directory: str) -> str:
    """Write the mini-biped MJCF into ``directory`` and return its path."""
    return _write(os.path.join(directory, "mini_biped.xml"), MINI_MJCF)


def write_g1_fixture(directory: str) -> str:
    """Write the G1-shaped MJCF into ``directory`` and return its path."""
    return _write(os.path.join(directory, "g1_shaped_fixture.xml"), g1_fixture_mjcf())


def write_wide_fixture(directory: str, extra: int) -> str:
    """Write the G1-shaped MJCF with ``extra`` more hinged links, hung off
    the wrists in turn (left, right, left, ...), and return its path: 32
    bodies, the most of the control-step kernel's narrow instance, at
    ``extra = 2``."""
    text = g1_fixture_mjcf()
    for k in range(extra):
        side = ("left", "right")[k % 2]
        head = f'<body name="{side}_wrist_yaw_link"'
        close = text.index("</body>", text.index(head))
        hand = (f'<body name="{side}_hand{k}_link" pos="0.1 0 0">'
                f'<inertial pos="0.03 0 0" mass="0.2" diaginertia="{_fmt(_box_inertia(0.2, (0.03, 0.02, 0.01)))}"/>'
                f'<joint name="{side}_hand{k}_joint" axis="{_Y}" range="-1 1" class="arm"/>'
                f'<geom type="box" pos="0.03 0 0" size="0.03 0.02 0.01"/></body>\n')
        text = text[:close] + hand + text[close:]
    return _write(os.path.join(directory, f"g1_fixture_plus{extra}.xml"), text)


def _box_triangles(half) -> np.ndarray:
    """The 12 outward-facing triangles [12, 3, 3] of a box of half-size
    ``half`` centered at the origin."""
    c = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float64) * np.asarray(half, np.float64)
    # corner index = 4*(x>0) + 2*(y>0) + (z>0); two triangles per face
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, e, d in quads:
        tris += [c[[a, b, e]], c[[a, e, d]]]
    return np.stack(tris)


def _write_box_stl(path: str, half) -> str:
    """Write a binary STL box of half-size ``half`` and return its path."""
    tris = _box_triangles(half).astype(np.float32)
    normals = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    with open(path, "wb") as f:
        f.write(b"agt box".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(tris)))
        for n, t in zip(normals.astype(np.float32), tris):
            f.write(n.tobytes() + t.tobytes() + b"\0\0")
    return path


def write_mesh_fixture(directory: str) -> str:
    """Write the G1-shaped MJCF with one visual mesh per body and return
    its path.

    Each body's collision box is repeated as a ``group="1"`` mesh geom
    (``contype="0" conaffinity="0"``, so the physics model skips it) whose
    binary STL box is written next to the MJCF as ``<body>_vis.STL``.
    """
    lines, meshes, body = [], [], None
    for line in g1_fixture_mjcf().splitlines():
        lines.append(line)
        m = re.search(r'<body name="([^"]+)"', line)
        if m:
            body = m.group(1)
            continue
        m = re.search(r'<geom type="box" pos="([^"]+)" size="([^"]+)"/>', line)
        if m:
            name = f"{body}_vis"
            half = [float(x) for x in m.group(2).split()]
            _write_box_stl(os.path.join(directory, f"{name}.STL"), half)
            meshes.append(f'    <mesh name="{name}" file="{name}.STL"/>')
            indent = line[:len(line) - len(line.lstrip())]
            lines.append(f'{indent}<geom type="mesh" mesh="{name}" pos="{m.group(1)}" group="1" '
                         f'contype="0" conaffinity="0"/>')
    text = "\n".join(lines) + "\n"
    text = text.replace("  <worldbody>", "  <asset>\n" + "\n".join(meshes) + "\n  </asset>\n"
                        "  <worldbody>", 1)
    return _write(os.path.join(directory, "g1_mesh_fixture.xml"), text)


# a crouched base pose inside every joint range (motion column order)
_G1_BASE_POSE = {
    "hip_pitch": -0.2, "knee": 0.4, "ankle_pitch": -0.2, "elbow": 0.3,
    "shoulder_roll": 0.2,
}


def synthetic_motion_frames(seed: int, num_frames: int = 90, fps: float = 30.0,
                            joint_order=MOTION_JOINT_ORDER,
                            height: float = G1_PELVIS_HEIGHT) -> np.ndarray:
    """[T, 7 + nd] frames of a smooth random motion from a numpy seed.

    Root walks forward at 0.3 m/s with a slow yaw sway; joints oscillate by
    up to 0.15 rad around a crouched base pose.
    """
    rng = np.random.default_rng(seed)
    nd = len(joint_order)
    t = np.arange(num_frames) / fps
    amp = rng.uniform(0.03, 0.15, nd)
    freq = rng.uniform(0.5, 1.5, nd)
    phase = rng.uniform(0.0, 2.0 * np.pi, nd)
    base = np.zeros(nd)
    for j, name in enumerate(joint_order):
        for key, val in _G1_BASE_POSE.items():
            if key in name:
                base[j] = val if "right_shoulder_roll" not in name else -val
    dof = base + amp * np.sin(2.0 * np.pi * freq * t[:, None] + phase)

    yaw = 0.1 * np.sin(2.0 * np.pi * 0.5 * t)
    root_pos = np.stack(
        [0.3 * t, 0.02 * np.sin(2.0 * np.pi * t), height + 0.01 * np.sin(4.0 * np.pi * t)],
        axis=-1,
    )
    quat_xyzw = np.stack(
        [np.zeros_like(yaw), np.zeros_like(yaw), np.sin(0.5 * yaw), np.cos(0.5 * yaw)],
        axis=-1,
    )
    return np.concatenate([root_pos, quat_xyzw, dof], axis=-1)


def write_motion_csv(path: str, seed: int, num_frames: int = 90, **kw) -> str:
    """Write a synthetic ``.motion`` CSV clip (30 fps) and return its path."""
    frames = synthetic_motion_frames(seed, num_frames, **kw)
    return _replace(path, lambda f: np.savetxt(f, frames, delimiter=",", fmt="%.9g"))


SLICE_CLIP = "g1_fixture_clip.motion"


def write_slice_files(directory: str):
    """The G1-shaped fixture and its synthetic 300-frame clip (seed 0),
    written into ``directory``: (MJCF path, clip path)."""
    return (write_g1_fixture(directory),
            write_motion_csv(os.path.join(directory, SLICE_CLIP), seed=0, num_frames=300))


def slice_config(directory: str, name: str = "train", overrides=()):
    """The port's config ``name`` with ``overrides``, on the files of
    :func:`write_slice_files` (which replace any robot asset or clip)."""
    g1_path, clip_path = write_slice_files(directory)
    cfg = load_config(name, list(overrides))
    cfg["robot"]["asset_path"] = g1_path
    cfg["task"]["motion_file"] = clip_path
    return cfg


def write_motion_pickle(path: str, seed: int, loop_mode: int = 1,
                        num_frames: int = 90, fps: int = 30, **kw) -> str:
    """Write the synthetic clip as a pickle clip with ``loop_mode``
    (1 = WRAP) and return its path."""
    frames = synthetic_motion_frames(seed, num_frames, fps=float(fps), **kw)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"loop_mode": int(loop_mode), "fps": fps, "frames": frames}, f)
    return path


def random_sim_state(model, n: int, seed: int, height: float, device="cpu"):
    """A batch of states with ground contact and non-zero velocities, and a
    PD command, made from a numpy seed: ``(fields, command)`` where
    ``fields`` maps each ``SimState`` field to a float32 numpy array.

    The root sits between 8 cm below and 2 cm above ``height`` (the
    standing root height), tilted by ~0.1 rad; joints lie inside their
    limits; velocities are ~N(0, 0.5) (root) and ~N(0, 1) (joints).
    """
    rng = np.random.default_rng(seed)
    nd = model.nd
    lo, hi = model.dof_limit[:, 0], model.dof_limit[:, 1]
    q = np.clip(rng.normal(0.0, 0.3, (n, nd)), lo, hi)
    quat = np.concatenate([np.ones((n, 1)), 0.1 * rng.normal(size=(n, 3))], axis=1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    fields = dict(
        root_pos=np.stack(
            [rng.normal(0, 0.1, n), rng.normal(0, 0.1, n), height + rng.uniform(-0.08, 0.02, n)],
            axis=1,
        ),
        root_quat=quat,
        root_vel=rng.normal(0.0, 0.5, (n, 3)),
        root_ang_vel=rng.normal(0.0, 0.3, (n, 3)),
        dof_pos=q,
        dof_vel=rng.normal(0.0, 1.0, (n, nd)),
        pd_target=q + rng.normal(0.0, 0.1, (n, nd)),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    command = (q + rng.normal(0.0, 0.4, (n, nd))).astype(np.float32)
    return fields, command


def per_env_params(kp, kv, n: int, seed: int, mass_range=(0.5, 2.0)):
    """Per-env control parameters as domain randomization draws them, made
    from a numpy seed: a dict of float32 arrays ``kp``/``kv`` [n, nd] (the
    shared gains times log-uniform scales in [0.8, 1.2]), ``friction_mu``
    [n] (log-uniform in [0.6, 1.4]) and ``mass_scale`` [n] (log-uniform in
    ``mass_range``).  The ranges are the ``dr_pod`` config's, with the mass
    range widened by default so that the mass scale matters."""
    rng = np.random.default_rng(seed)

    def logu(lo, hi, *shape):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), shape)).astype(np.float32)

    return dict(
        kp=np.asarray(kp, np.float32)[None] * logu(0.8, 1.2, n, 1),
        kv=np.asarray(kv, np.float32)[None] * logu(0.8, 1.2, n, 1),
        friction_mu=logu(0.6, 1.4, n),
        mass_scale=logu(*mass_range, n),
    )


STATE_FIELDS = ("root_pos", "root_quat", "root_vel", "root_ang_vel", "dof_pos", "dof_vel",
                "pd_target")


def step_tolerances() -> dict:
    """Tolerances (rtol/atol per output) for one control step computed two
    ways in f32 (kernel vs plain version, port vs JAX package).

    The ground springs (~2e4 N/m per point on the G1-shaped fixture, 4e4
    on the mini biped) act on penetrations that are differences of ~1 m
    heights, so one f32 ulp of height (6e-8 m) is ~1e-3 N per point and up
    to ~1e-2 N per body; through a light link's inertia that moves a
    velocity by up to ~4e-5 per control step.  Positions and quaternions
    stay at a few ulps.
    """
    pos = dict(rtol=1e-5, atol=1e-5)
    vel = dict(rtol=1e-5, atol=1e-4)
    return dict(
        root_pos=pos, root_quat=pos, root_vel=vel, root_ang_vel=vel,
        dof_pos=pos, dof_vel=vel, pd_target=pos, contact=dict(rtol=1e-5, atol=5e-2),
    )
