"""The benchmark's inputs: a robot (by name, ``ROBOTS``) and a synthetic
clip.

A frozen copy of the port's fixture writers (``physics/testing.py`` at the
commit that added this benchmark), so that later changes to the program
cannot move the inputs.  The G1's own description files and its 42
mocap clips are not in the repository; the fixture has the G1's 30
bodies and 29 hinges, named and nested as the G1's MJCF names them, with
link offsets, joint axes, ranges and masses close to the G1's, and the
clip is a smooth 300-frame walk with joint oscillations from a numpy seed.
``g1_dex3`` is a topology stand-in for the G1 with Dex3-1 hands: the same
fixture with 7 hinges on each wrist, named and nested as Unitree's
``g1_29dof_with_hand`` names them (44 bodies, 43 hinges, 13 levels), but
with finger geometry and masses of its own, as the repository holds no
Dex3-1 description.  Both files are written into a fixed directory of the
checkout and read, as raw files, by the program and by the reference
alike.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np

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


def write_g1_fixture(directory: str) -> str:
    """Write the G1-shaped MJCF into ``directory`` and return its path."""
    return _write(os.path.join(directory, "g1_shaped_fixture.xml"), g1_fixture_mjcf())


# The Dex3-1 hand's three fingers, each a chain hung on <side>_wrist_yaw_link
# (link as in _LEG; joint <side>_hand_<name>_joint).  The palm is the wrist-yaw
# link's own box: a palm on a fixed joint compiles into its parent's geometry
# in MJCF.  The repository holds no Dex3-1 description, so every offset, axis,
# range, mass and box here is this fixture's own assumption, sized like a
# small three-fingered hand: the hand's topology is Unitree's, its dynamics are
# not, and a configuration on this robot lists the hand geometry as assumed; each range holds the clip's 0.15 rad swing about
# 0.  The right hand mirrors y, so its x- and z-axis ranges swap sign.
_HAND = [
    [("hand_thumb_0", _Y, (-1.0472, 1.0472), (0.067, 0.003, 0.0), 0.086,
      (0.0, 0.012, 0.0), (0.012, 0.012, 0.012), "hand"),
     ("hand_thumb_1", _Z, (-0.7243, 1.0472), (-0.0025, 0.0193, 0.0), 0.056,
      (0.0, 0.02, 0.0), (0.01, 0.02, 0.01), "hand"),
     ("hand_thumb_2", _Z, (-0.5, 1.7453), (0.0, 0.0458, 0.0), 0.035,
      (0.0, 0.018, 0.0), (0.009, 0.018, 0.009), "hand")],
    [("hand_index_0", _Z, (-1.5708, 0.5), (0.1, 0.0046, 0.0285), 0.048,
      (0.022, 0.0, 0.0), (0.022, 0.01, 0.009), "hand"),
     ("hand_index_1", _Z, (-1.7453, 0.5), (0.0458, 0.0, 0.0), 0.029,
      (0.018, 0.0, 0.0), (0.018, 0.009, 0.008), "hand")],
    [("hand_middle_0", _Z, (-1.5708, 0.5), (0.1, 0.0046, -0.0285), 0.048,
      (0.022, 0.0, 0.0), (0.022, 0.01, 0.009), "hand"),
     ("hand_middle_1", _Z, (-1.7453, 0.5), (0.0458, 0.0, 0.0), 0.029,
      (0.018, 0.0, 0.0), (0.018, 0.009, 0.008), "hand")],
]
_HAND_MIRRORED = {spec[0]: (-spec[2][1], -spec[2][0])
                  for finger in _HAND for spec in finger if spec[1] != _Y}

G1_DEX3_MOTION_JOINT_ORDER = MOTION_JOINT_ORDER + [
    f"{side}_{spec[0]}_joint" for side in ("left", "right") for finger in _HAND for spec in finger
]

_HAND_CLASS = """    <default class="hand">
      <joint damping="0.05" armature="0.01" frictionloss="0.05"/>
    </default>
"""


def g1_dex3_fixture_mjcf() -> str:
    """MJCF text of a topology stand-in for the G1 with Dex3-1 hands (44
    bodies, 43 hinges): ``g1_fixture_mjcf()``'s bodies unchanged, the
    fingers of ``_HAND`` (assumed geometry) added inside each wrist-yaw
    link."""
    text = g1_fixture_mjcf().replace('model="g1_shaped_fixture"', 'model="g1_dex3_shaped_fixture"')
    text = text.replace("  </default>\n  <worldbody>", _HAND_CLASS + "  </default>\n  <worldbody>")
    for side in ("left", "right"):
        close = text.index(" " * 22 + "</body>", text.index(f'<body name="{side}_wrist_yaw_link"'))
        fingers = "\n".join(_chain(side, finger, 24, side == "right", _HAND_MIRRORED)
                            for finger in _HAND)
        text = text[:close] + fingers + "\n" + text[close:]
    return text


def write_g1_dex3_fixture(directory: str) -> str:
    """Write the G1 + Dex3-1 MJCF into ``directory`` and return its path."""
    return _write(os.path.join(directory, "g1_dex3_shaped_fixture.xml"), g1_dex3_fixture_mjcf())


class Robot(NamedTuple):
    write: Callable[[str], str]      # writes the fixture into a directory
    joint_order: list                # the column order of its motion files
    clip_suffix: str                 # clip_<seed><clip_suffix>.motion


ROBOTS = {
    "g1": Robot(write_g1_fixture, MOTION_JOINT_ORDER, ""),
    "g1_dex3": Robot(write_g1_dex3_fixture, G1_DEX3_MOTION_JOINT_ORDER, "_g1_dex3"),
}


def robot(name: str) -> Robot:
    """The entry of ``ROBOTS`` named ``name``; a ``KeyError`` that lists the
    known names otherwise."""
    if name not in ROBOTS:
        raise KeyError(f"unknown robot {name!r}; the known robots are {sorted(ROBOTS)}")
    return ROBOTS[name]


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


CLIP_FRAMES = 300


def write_inputs(directory: str, clip_seed: int = 0, name: str = "g1"):
    """The fixture of robot ``name`` and a synthetic clip in its joint
    order in ``directory``: (MJCF path, clip path).  The G1's are
    ``g1_shaped_fixture.xml`` and ``clip_<seed>.motion``."""
    entry = robot(name)
    clip = os.path.join(directory, f"clip_{clip_seed}{entry.clip_suffix}.motion")
    return (entry.write(directory),
            write_motion_csv(clip, seed=clip_seed, num_frames=CLIP_FRAMES,
                             joint_order=entry.joint_order))
