"""Port parity: the geom-geom narrowphase (``physics/narrowphase.py``).

Each query and force function of the port against the JAX package's on the
same numpy-seeded inputs:

* ``segment_closest_points`` on random segment pairs plus parallel,
  collinear and degenerate (point) cases: 1e-6 (the same f32 formula);
* ``box_surface_point`` on points inside, outside, on faces and at the
  corners of boxes, and interior points equally near two faces (the
  first-minimum tie rule): q, n, sd within 1e-6, normals of ties exact;
* ``segment_box_closest``: the signed distance within 1e-5 (the
  24-round ternary search takes the same branches up to f32 ties, and the
  distance is flat at the optimum), the points within 1e-4;
* ``capsule_pair_forces`` / ``capsule_f_ext`` and ``geom_f_ext`` on the
  G1-shaped fixture's tables from perturbed states with active pairs:
  forces reach ~1e3 N and each body sums up to a few hundred contacts in
  another order than JAX's scatter-add, so wrenches are held at rtol 1e-4,
  atol 1e-2 (N, N m);
* the host tables (``parse_geoms`` / ``rest_pose_prune`` /
  ``parse_capsules``): exactly equal, on the fixture and on a mixed MJCF;
* Newton's third law: the summed forces over all bodies vanish.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.physics import engine as jeng
from add_gym_tpu.physics import narrowphase as jnp_np
from add_gym_tpu.physics.model import attach_geoms as jax_attach_geoms
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_torch.physics import engine as teng
from add_gym_torch.physics import narrowphase as tnp
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import SimState
from add_gym_torch.physics.model import attach_geoms, build_physics_model

torch.set_num_threads(2)

GEOM_FIELDS = ("seg_body", "seg_p0", "seg_p1", "seg_radius", "box_body", "box_pos", "box_rot",
               "box_half", "ss_pairs", "ss_mass", "sb_pairs", "sb_mass", "bb_pairs", "bb_mass")
CAPSULE_FIELDS = ("body", "p0", "p1", "radius", "pairs", "stiff_mass")
WRENCH_TOL = dict(rtol=1e-4, atol=1e-2)

MIXED_MJCF = """
<mujoco>
  <worldbody>
    <body name="a" pos="0 0 1">
      <geom type="sphere" size="0.1"/>
      <geom type="capsule" fromto="0 0 0  0 0 0.4" size="0.05 0.2"/>
      <body name="b" pos="0 0 0.5">
        <geom type="box" size="0.1 0.2 0.3"/>
        <geom type="capsule" size="0.04 0.1" pos="0.1 0 0" quat="0.7071068 0 0.7071068 0"/>
      </body>
      <body name="c" pos="0.5 0 0">
        <geom type="box" size="0.1 0.1 0.1"/>
        <geom type="cylinder" size="0.03 0.2"/>
        <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
        <body name="d" pos="0 0 -0.4">
          <geom type="box" size="0.05 0.05 0.05" quat="0.9238795 0 0 0.3826834"/>
          <geom type="capsule" size="0.03 0.1"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------------------------ queries


def test_segment_closest_points_matches_jax():
    rng = np.random.default_rng(0)
    cases = list(rng.normal(size=(64, 4, 3)))
    cases += [
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], float),     # parallel
        np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], float),     # collinear
        np.array([[0, 0, 0], [1, 0, 0], [0.5, 0, 0], [3, 0, 0]], float),   # overlapping
        np.array([[0, 0, 0], [0, 0, 0], [1, 1, 1], [1, 1, 1]], float),     # two points
        np.array([[0, 0, 0], [1, 0, 0], [.5, .3, 0], [.5, .3, 0]], float),  # segment, point
        np.array([[.2, .1, 0], [.2, .1, 0], [0, 0, 0], [0, 1, 0]], float),  # point, segment
    ]
    arr = np.stack(cases).astype(np.float32)
    want = jnp_np.segment_closest_points(*(_j(arr[:, k]) for k in range(4)))
    got = tnp.segment_closest_points(*(_t(arr[:, k]) for k in range(4)))
    for g, w, what in zip(got, want, ("pa", "pb")):
        _close(g, w, 1e-6, what)


def _box_points(rng):
    """Local points and half extents: inside, outside, on faces, at and
    beyond corners, and interior points equally near two faces."""
    h = rng.uniform(0.1, 0.5, (40, 3)).astype(np.float32)
    inside = (h * rng.uniform(-0.95, 0.95, (40, 3))).astype(np.float32)
    outside = (h * rng.uniform(1.1, 3.0, (40, 3)) * rng.choice([-1, 1], (40, 3))).astype(np.float32)
    corners = (h * rng.choice([-1.0, 1.0], (40, 3))).astype(np.float32)
    past = (corners * 1.5).astype(np.float32)
    face = inside.copy()
    face[:, 0] = h[:, 0]
    cube = np.full((40, 3), 0.3, np.float32)                # ties: equal half extents
    tie = np.zeros((40, 3), np.float32)
    tie[:, 0] = rng.uniform(-0.1, 0.1, 40)                  # x and y faces, then all three
    tie[20:, 1] = tie[20:, 0]
    l = np.concatenate([inside, outside, corners, past, face, tie])
    hh = np.concatenate([h, h, h, h, h, cube])
    return l, hh


def test_box_surface_point_matches_jax():
    l, h = _box_points(np.random.default_rng(1))
    want = jnp_np.box_surface_point(_j(l), _j(h))
    got = tnp.box_surface_point(_t(l), _t(h))
    for g, w, what in zip(got, want, ("q", "n", "sd")):
        _close(g, w, 1e-6, what)
    # interior ties leave through the same face in both packages
    np.testing.assert_array_equal(got[1][-40:].numpy(), np.asarray(want[1][-40:]))
    assert (got[2][:40] < 0).all() and (got[2][40:80] > 0).all()


def test_segment_box_closest_matches_jax():
    rng = np.random.default_rng(2)
    n = 64
    h = rng.uniform(0.1, 0.5, (n, 3)).astype(np.float32)
    a = rng.normal(0.0, 0.6, (n, 3)).astype(np.float32)
    b = rng.normal(0.0, 0.6, (n, 3)).astype(np.float32)
    b[:8] = a[:8]                                         # degenerate: points
    want = jnp_np.segment_box_closest(_j(a), _j(b), _j(h))
    got = tnp.segment_box_closest(_t(a), _t(b), _t(h))
    _close(got[3], want[3], 1e-5, "sd")
    for g, w, what in zip(got[:3], want[:3], ("p", "q", "n")):
        _close(g, w, 1e-4, what)
    sd = got[3].numpy()
    assert (sd < 0).any() and (sd > 0).any()              # penetrating and separated


# ------------------------------------------------------------------ forces


@pytest.fixture(scope="module")
def g1(tmp_path_factory):
    path = fx.write_g1_fixture(str(tmp_path_factory.mktemp("np_g1")))
    return path, attach_geoms(build_physics_model(path), path), \
        jax_attach_geoms(jax_build_model(path), path)


def _perturbed_kinematics(tm, jm, n, seed):
    """FK and body velocities of both packages for a standing state with
    joints bent by 0.2 N(0, 1) (``testing.random_sim_state`` otherwise)."""
    fields, _ = fx.random_sim_state(tm, n, seed=seed, height=fx.G1_PELVIS_HEIGHT)
    rng = np.random.default_rng(seed)
    fields["dof_pos"] = np.clip(fields["dof_pos"] + 0.2 * rng.normal(size=fields["dof_pos"].shape),
                                tm.dof_limit[:, 0], tm.dof_limit[:, 1]).astype(np.float32)
    ts = SimState(**{k: _t(v) for k, v in fields.items()})
    js = jeng.SimState(**{k: _j(v) for k, v in fields.items()})
    bp, br = teng.forward_kinematics(tm, ts)
    om, vo = teng._body_world_velocities(tm, ts, br)
    jbp, jbr = jeng.forward_kinematics(jm, js)
    jom, jvo = jeng._body_world_velocities(jm, js, jbr)
    return (bp, br, om, vo), (jbp, jbr, jom, jvo)


def test_geom_f_ext_matches_jax(g1):
    _, tm, jm = g1
    tk, jk = _perturbed_kinematics(tm, jm, 8, seed=3)
    dt, tc = 0.0025, 0.02
    want = np.asarray(jax.jit(
        lambda *k: jnp_np.geom_f_ext(jm.geoms, *k, dt, tc, jm.nb))(*jk))
    got = tnp.geom_f_ext(tm.geoms, *tk, dt, tc, tm.nb)
    _close(got, want, WRENCH_TOL["atol"], "geom_f_ext")
    np.testing.assert_allclose(got.numpy(), want, **WRENCH_TOL)
    assert np.abs(want).max() > 10.0                      # pairs are active
    # Newton's third law: the forces on all bodies sum to zero per env
    np.testing.assert_allclose(got[..., 3:6].sum(1).numpy(), 0.0, atol=1e-3)


def test_capsule_forces_match_jax(tmp_path):
    path = str(tmp_path / "mixed.xml")
    with open(path, "w") as f:
        f.write(MIXED_MJCF)
    m = build_physics_model_free(path)
    tcaps = tnp.parse_capsules(path, m.body_names, m.mass)
    jcaps = jnp_np.parse_capsules(path, m.body_names, m.mass)
    assert tcaps.num_pairs > 0
    for name in CAPSULE_FIELDS:
        np.testing.assert_array_equal(getattr(tcaps, name), getattr(jcaps, name), err_msg=name)
    # random poses that bring the capsules into contact
    rng = np.random.default_rng(4)
    n, nb = 16, 4
    pos = rng.normal(0.0, 0.08, (n, nb, 3)).astype(np.float32)
    q = rng.normal(size=(n, nb, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from add_gym_tpu.mathx.rotations import quat_to_matrix
    rot = np.asarray(quat_to_matrix(jnp.asarray(q)))
    om = rng.normal(0.0, 1.0, (n, nb, 3)).astype(np.float32)
    vo = rng.normal(0.0, 1.0, (n, nb, 3)).astype(np.float32)
    args = (pos, rot, om, vo)
    want = jnp_np.capsule_pair_forces(jcaps, *(_j(x) for x in args), 0.0025, 0.02)
    got = tnp.capsule_pair_forces(tcaps, *(_t(x) for x in args), 0.0025, 0.02)
    for g, w, what in zip(got, want, ("f", "pa", "pb", "fmag")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3, err_msg=what)
    assert float(got[3].max()) > 0.0
    want = jnp_np.capsule_f_ext(jcaps, *(_j(x) for x in args), 0.0025, 0.02, nb)
    got = tnp.capsule_f_ext(tcaps, *(_t(x) for x in args), 0.0025, 0.02, nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WRENCH_TOL)
    np.testing.assert_allclose(got[..., 3:6].sum(1).numpy(), 0.0, atol=1e-3)


def build_physics_model_free(path):
    """The mixed MJCF has no inertials or joints: a model of just what the
    narrowphase tables read (body names, masses, the tree)."""
    from types import SimpleNamespace

    names = ["a", "b", "c", "d"]
    return SimpleNamespace(body_names=names, mass=np.array([1.0, 2.0, 3.0, 0.5], np.float32),
                           parent=np.array([-1, 0, 0, 2]), local_pos=np.array(
                               [[0, 0, 1], [0, 0, 0.5], [0.5, 0, 0], [0, 0, -0.4]], np.float32),
                           local_quat=np.tile(np.array([1, 0, 0, 0], np.float32), (4, 1)))


# ------------------------------------------------------------------- tables


def _assert_tables_equal(got, want):
    for name in GEOM_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_geom_tables_equal_on_the_fixture(g1):
    path, tm, jm = g1
    _assert_tables_equal(tm.geoms, jm.geoms)
    assert (len(tm.geoms.ss_pairs), len(tm.geoms.sb_pairs), len(tm.geoms.bb_pairs)) == (16, 224, 397)
    # pruning removed pairs: the unpruned tables are equal too, and larger
    raw = tnp.parse_geoms(path, tm.body_names, tm.mass)
    _assert_tables_equal(raw, jnp_np.parse_geoms(path, jm.body_names, jm.mass))
    assert raw.num_pairs > tm.geoms.num_pairs
    assert len(tnp.touched_bodies(None, tm.geoms)) == tm.nb


def test_geom_tables_equal_on_a_mixed_mjcf(tmp_path):
    path = str(tmp_path / "mixed.xml")
    with open(path, "w") as f:
        f.write(MIXED_MJCF)
    m = build_physics_model_free(path)
    for adjacent in (True, False):
        got = tnp.parse_geoms(path, m.body_names, m.mass, exclude_adjacent=adjacent)
        want = jnp_np.parse_geoms(path, m.body_names, m.mass, exclude_adjacent=adjacent)
        _assert_tables_equal(got, want)
        pruned = tnp.rest_pose_prune(got, m.parent, m.local_pos, m.local_quat, margin=0.03)
        _assert_tables_equal(pruned, jnp_np.rest_pose_prune(want, m.parent, m.local_pos,
                                                            m.local_quat, margin=0.03))
    assert got.seg_body.tolist() == [0, 0, 1, 2, 3]       # the visual sphere is filtered out
    assert got.box_body.tolist() == [1, 2, 3]
    caps = tnp.parse_capsules(path, m.body_names, m.mass, exclude_adjacent=False)
    want = jnp_np.parse_capsules(path, m.body_names, m.mass, exclude_adjacent=False)
    for name in CAPSULE_FIELDS:
        np.testing.assert_array_equal(getattr(caps, name), getattr(want, name), err_msg=name)


def test_no_tables_no_wrenches(g1):
    """A model without tables has no touched bodies, and an empty GeomSet
    gives zero wrenches."""
    _, tm, _ = g1
    assert len(tnp.touched_bodies(None, None)) == 0
    empty = tnp.GeomSet(**{f: getattr(tm.geoms, f)[:0] for f in GEOM_FIELDS})
    pos = torch.zeros((2, tm.nb, 3))
    rot = torch.eye(3).expand(2, tm.nb, 3, 3)
    out = tnp.geom_f_ext(empty, pos, rot, pos, pos, 0.0025, 0.02, tm.nb)
    assert out.shape == (2, tm.nb, 6) and not out.any()
