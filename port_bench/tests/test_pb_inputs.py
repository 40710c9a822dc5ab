"""The robots a configuration can name (``inputs.ROBOTS``) and the files
written for them.

* The G1's fixture and clip are byte for byte what the benchmark wrote
  before a configuration could name its robot (sha256 pinned from that
  tree), so the G1 cells' inputs never move.
* Each robot's fixture parses in the reference with its bodies, hinges and
  tree depth, a PD gain for every joint, and a control-step bound by
  operations; the G1 + Dex3-1 fixture is the G1 fixture's text with the
  fingers added, and its fingers take the ``hand`` gain.
"""

import hashlib
import os
import re

import numpy as np
import pytest

from port_bench import ceiling, inputs, spec
from port_bench.reference.kinematics.char_model import load_char_model
from port_bench.reference.physics.model import build_physics_model
from port_bench.reference.robot import build_pd_gains

G1_FIXTURE_SHA256 = "6ef82897ede5995a395f9809669588cabf145ea265316c09a5e2444053634eb2"
G1_CLIP_SHA256 = {
    0: "9a04300b7c119ef9acd305601433a8e46bfb7965ef7f31ae5b514c2a5a6df414",
    7: "d6f034e39a97ec20058377f75a2be4929efbfebc3a870243cb8bec71f636cad6",
    3000000001: "b18fa8a95716844c6ba92613b2a4334ebbf8fbc2b955de856581ae77674faf81",
}
# robot: (bodies, hinges, tree depth, ground points)
SHAPES = {"g1": (30, 29, 10, 248), "g1_dex3": (44, 43, 13, 360)}


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("seed", sorted(G1_CLIP_SHA256))
@pytest.mark.parametrize("workload", ["g1_add.cloud", "g1_dr.pod_one_card"])
def test_g1_inputs_are_byte_identical(tmp_path, workload, seed):
    cell = spec.workload(workload)
    assert spec.robot(cell) == "g1"
    mjcf, clip = spec.write_inputs(cell, str(tmp_path), seed)
    assert (os.path.basename(mjcf), os.path.basename(clip)) == ("g1_shaped_fixture.xml",
                                                                 f"clip_{seed}.motion")
    assert _sha256(mjcf) == G1_FIXTURE_SHA256
    assert _sha256(clip) == G1_CLIP_SHA256[seed]
    assert inputs.write_inputs(str(tmp_path / "bare"), clip_seed=seed) == (
        str(tmp_path / "bare" / "g1_shaped_fixture.xml"),
        str(tmp_path / "bare" / f"clip_{seed}.motion"))
    assert _sha256(str(tmp_path / "bare" / f"clip_{seed}.motion")) == G1_CLIP_SHA256[seed]


def test_robots_write_apart_and_unknown_names_raise(tmp_path):
    g1 = inputs.write_inputs(str(tmp_path), clip_seed=3)
    dex3 = inputs.write_inputs(str(tmp_path), clip_seed=3, name="g1_dex3")
    assert [os.path.basename(p) for p in dex3] == ["g1_dex3_shaped_fixture.xml",
                                                   "clip_3_g1_dex3.motion"]
    assert not set(g1) & set(dex3)
    assert np.loadtxt(g1[1], delimiter=",").shape == (inputs.CLIP_FRAMES, 7 + 29)
    assert np.loadtxt(dex3[1], delimiter=",").shape == (inputs.CLIP_FRAMES, 7 + 43)
    with pytest.raises(KeyError, match="g1_dex3"):
        inputs.write_inputs(str(tmp_path), name="h1")

    # a configuration's joint order has to be its robot's own
    cell = spec.workload("g1_add.cloud")
    cell["config"] = dict(cell["config"], inputs={"robot": "g1_dex3"})
    with pytest.raises(ValueError, match="motion_joint_order"):
        spec.write_inputs(cell, str(tmp_path / "mixed"), 3)
    cell["config"]["inputs"] = {"robot": "h1"}
    with pytest.raises(KeyError, match="g1_dex3"):
        spec.write_inputs(cell, str(tmp_path / "mixed"), 3)
    assert not (tmp_path / "mixed").exists()


def _without_fingers(text):
    """``text`` less the finger bodies and the ``hand`` joint class."""
    out, end = [], None
    for line in text.splitlines(keepends=True):
        if end is None:
            m = re.match(r'( *)(<body name="\w+_hand_|<default class="hand")', line)
            if m:
                end = m.group(1) + ("</body>" if "body" in m.group(2) else "</default>")
                continue
            out.append(line)
        elif line.rstrip("\n") == end:
            end = None
    return "".join(out)


def test_dex3_is_the_g1_fixture_with_fingers():
    text = inputs.g1_dex3_fixture_mjcf()
    g1 = inputs.g1_fixture_mjcf()
    assert _without_fingers(text) == g1.replace('model="g1_shaped_fixture"',
                                                'model="g1_dex3_shaped_fixture"')
    assert len(inputs.G1_DEX3_MOTION_JOINT_ORDER) == 43
    assert inputs.G1_DEX3_MOTION_JOINT_ORDER[:29] == inputs.MOTION_JOINT_ORDER
    for side in ("left", "right"):
        for name in ("thumb_0", "thumb_1", "thumb_2", "index_0", "index_1", "middle_0",
                     "middle_1"):
            assert f'<body name="{side}_hand_{name}_link"' in text
            assert f'<joint name="{side}_hand_{name}_joint"' in text


@pytest.mark.parametrize("robot", sorted(SHAPES))
def test_fixture_parses_in_the_reference(tmp_path, robot):
    entry = inputs.ROBOTS[robot]
    path = entry.write(str(tmp_path))
    char = load_char_model(path)
    model = build_physics_model(path, char)
    nb, nd, depth, ncp = SHAPES[robot]
    assert (model.nb, model.nd, len(model.cp_body)) == (nb, nd, ncp)
    parent = char.parent_indices
    levels = np.zeros(nb, int)
    for i in range(1, nb):
        assert 0 <= parent[i] < i
        levels[i] = levels[parent[i]] + 1
    assert levels.max() == depth
    hinges = [n for n in char.joint_names if n != "root"]
    assert sorted(hinges) == sorted(entry.joint_order)

    kp, kv = build_pd_gains(model, gain_scale=1.2)      # raises on a joint without a gain
    fingers = [i for i, n in enumerate(model.joint_names) if "_hand_" in n]
    assert len(fingers) == nd - 29
    np.testing.assert_allclose(kp[fingers], 20.0 * 1.2, rtol=1e-6)
    assert (kp[[i for i in range(nd) if i not in fingers]] > 20.0 * 1.2).all()

    counts = ceiling.model_counts(model, 4, True)
    assert counts[:3] == (nb, nd, ncp)
    assert ceiling.control_step_bound(counts, 4096)[1] == "operations"
