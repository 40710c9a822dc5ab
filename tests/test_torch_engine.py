"""Port parity: the reference-layout engine (``physics/engine.py``,
``aba.py``, ``spatial.py``) and the held narrowphase wrenches of the plain
step (``fused_step.compute_np_ext`` / ``merge_ext`` / ``fused_substep``).

Against the JAX package on the same numpy-seeded inputs, on the mini biped
and the G1-shaped fixture:

* ``spatial`` algebra and ``index_sum`` (JAX's scatter-add): 1e-5 relative
  (products of O(1) terms; the sums run in another order);
* ``forward_kinematics`` / ``_body_world_velocities``: 1e-5;
* ``contact_forces`` and ``self_collision_forces``: rtol 1e-5, atol 5e-2 N
  (ground springs of ~2e4 N/m turn one f32 ulp of a ~1 m height into
  ~1e-3 N per point, see ``physics.testing.step_tolerances``);
* ``aba``: rtol 1e-4, atol 1e-3 in accelerations (a 6x6 solve and 30-body
  recursions in another op order, on contact wrenches of ~1e2 N);
* one ``engine.step``, plain and with per-env gains, friction and mass
  scale: ``step_tolerances()``; ``contact_pairs``: atol 5e-2 N;
* ``compute_np_ext``: wrenches at rtol 1e-4, atol 1e-2 (N, N m; sums of up
  to a few hundred contacts of ~1e3 N); ``fused_substep`` with geoms:
  ``step_tolerances()``.

Within the port: ``engine.step`` against ``fused_step`` with geoms
attached, 3 control steps from a perturbed standing state (joints + 0.2
N(0, 1)), at the JAX package's own tolerance for that comparison (atol
5e-4 in the state, 5e-2 N in contact; tests/test_narrowphase.py); and
``utils.debug.parity_check``, which passes on the CPU env and raises on a
backend that disagrees.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.physics import aba as jaba
from add_gym_tpu.physics import engine as jeng
from add_gym_tpu.physics import spatial as jsp
from add_gym_tpu.physics.fused_step import FusedModelConstants as JaxFMC
from add_gym_tpu.physics.fused_step import compute_np_ext as jax_np_ext
from add_gym_tpu.physics.fused_step import fused_substep as jax_fused_substep
from add_gym_tpu.physics.fused_step import merge_ext as jax_merge_ext
from add_gym_tpu.physics.model import attach_geoms as jax_attach_geoms
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_torch.physics import aba as taba
from add_gym_torch.physics import engine as teng
from add_gym_torch.physics import spatial as tsp
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import EngineParams, SimState
from add_gym_torch.physics.fused_step import (
    FusedModelConstants, compute_np_ext, fused_step, fused_substep, merge_ext,
)
from add_gym_torch.physics.model import attach_geoms, build_physics_model
from add_gym_torch.robot import build_pd_gains

torch.set_num_threads(2)

WRENCH_TOL = dict(rtol=1e-4, atol=1e-2)
CONTACT_TOL = dict(rtol=1e-5, atol=5e-2)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **tol)


# ------------------------------------------------------------------ spatial


def test_spatial_algebra_matches_jax():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    v, m, R, p = f(16, 6), f(16, 6), f(16, 3, 3), f(16, 3)
    I6 = f(16, 6, 6)
    for name, args in (("crm", (v, m)), ("crf", (v, m)), ("xform_motion", (R, p, v)),
                       ("inv_xform_force", (R, p, v)), ("xform_force", (R, p, v)),
                       ("skew", (p,)), ("xform_inertia", (R, p, I6))):
        got = getattr(tsp, name)(*(_t(a) for a in args))
        want = getattr(jsp, name)(*(jnp.asarray(a) for a in args))
        _close(got, want, name, rtol=1e-5, atol=1e-5)
    mass, com, inertia = np.abs(f(16)) + 0.1, f(16, 3), f(16, 3, 3)
    _close(tsp.spatial_inertia(_t(mass), _t(com), _t(inertia)),
           jsp.spatial_inertia(jnp.asarray(mass), jnp.asarray(com), jnp.asarray(inertia)),
           "spatial_inertia", rtol=1e-5, atol=1e-5)


def test_index_sum_matches_scatter_add():
    rng = np.random.default_rng(1)
    values = rng.normal(size=(4, 50, 6)).astype(np.float32)
    index = rng.integers(0, 7, 50)
    index[index == 3] = 2                                  # target 3 gets nothing
    want = jnp.zeros((4, 9, 6)).at[:, index].add(jnp.asarray(values))
    got = tsp.index_sum(_t(values), index, 9)
    _close(got, want, "index_sum", rtol=1e-5, atol=1e-5)
    assert not got[:, 3].any() and not got[:, 8].any()
    assert torch.equal(got, tsp.index_sum(_t(values), index, 9))


# --------------------------------------------------------------- fixtures


def _gains(model, g1):
    if g1:
        return build_pd_gains(model)
    return np.full(model.nd, 50.0, np.float32), np.full(model.nd, 5.0, np.float32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("engine"))
    out = {}
    for name, path in (("mini", fx.write_mini_mjcf(d)), ("g1", fx.write_g1_fixture(d))):
        tm, jm = build_physics_model(path), jax_build_model(path)
        kp, kv = _gains(tm, name == "g1")
        tp = EngineParams(kp=torch.as_tensor(kp), kv=torch.as_tensor(kv))
        jp = jeng.EngineParams(kp=jnp.asarray(kp), kv=jnp.asarray(kv))
        out[name] = dict(path=path, tm=tm, jm=jm, tp=tp, jp=jp,
                         height=fx.G1_PELVIS_HEIGHT if name == "g1" else 0.6)
    return out


@pytest.fixture(scope="module")
def geoms(models):
    g = models["g1"]
    tm = attach_geoms(g["tm"], g["path"])
    jm = jax_attach_geoms(g["jm"], g["path"])
    return tm, jm


def _states(model, n, seed, height, bend=0.0):
    fields, cmd = fx.random_sim_state(model, n, seed=seed, height=height)
    if bend:
        rng = np.random.default_rng(seed)
        fields["dof_pos"] = np.clip(
            fields["dof_pos"] + bend * rng.normal(size=fields["dof_pos"].shape),
            model.dof_limit[:, 0], model.dof_limit[:, 1]).astype(np.float32)
    ts = SimState(**{k: _t(v) for k, v in fields.items()})
    js = jeng.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return ts, js, cmd


def _assert_states_close(t_state, t_contact, j_state, j_contact, tols=None):
    tols = tols or fx.step_tolerances()
    for f in fx.STATE_FIELDS:
        _close(getattr(t_state, f), getattr(j_state, f), f, **tols[f])
    _close(t_contact, j_contact, "contact", **tols["contact"])


# ------------------------------------------------------------- kinematics


@pytest.mark.parametrize("which", ["mini", "g1"])
def test_kinematics_and_contacts_match_jax(models, which):
    m = models[which]
    tm, jm = m["tm"], m["jm"]
    ts, js, _ = _states(tm, 8, seed=2, height=m["height"])
    bp, br = teng.forward_kinematics(tm, ts)
    jbp, jbr = jeng.forward_kinematics(jm, js)
    _close(bp, jbp, "body_pos", rtol=1e-5, atol=1e-5)
    _close(br, jbr, "body_rot", rtol=1e-5, atol=1e-5)
    om, vo = teng._body_world_velocities(tm, ts, br)
    jom, jvo = jeng._body_world_velocities(jm, js, jbr)
    _close(om, jom, "omega", rtol=1e-5, atol=1e-5)
    _close(vo, jvo, "v_origin", rtol=1e-5, atol=1e-5)

    dt = 0.0025
    f_ext, contact = teng.contact_forces(tm, m["tp"], bp, br, ts, dt)
    jf_ext, jcontact = jeng.contact_forces(jm, m["jp"], jbp, jbr, js, dt)
    _close(f_ext, jf_ext, "contact f_ext", **CONTACT_TOL)
    _close(contact, jcontact, "contact", **CONTACT_TOL)
    assert (contact > 0).any()
    sc = teng.self_collision_forces(tm, m["tp"], bp, br, om, vo, dt)
    jsc = jeng.self_collision_forces(jm, m["jp"], jbp, jbr, jom, jvo, dt)
    _close(sc, jsc, "self collision", **CONTACT_TOL)


def test_self_collision_forces_of_crossed_legs_match_jax(models):
    """Legs crossed by hip roll: the sphere pairs push (non-zero wrenches)."""
    m = models["g1"]
    tm, jm = m["tm"], m["jm"]
    fields, _ = fx.random_sim_state(tm, 8, seed=6, height=fx.G1_PELVIS_HEIGHT)
    fields["dof_pos"][:] = 0.0
    for j, name in enumerate(tm.joint_names):
        if "hip_roll" in name:
            fields["dof_pos"][:, j] = -0.35 if name.startswith("left") else 0.35
    ts = SimState(**{k: _t(v) for k, v in fields.items()})
    js = jeng.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    bp, br = teng.forward_kinematics(tm, ts)
    om, vo = teng._body_world_velocities(tm, ts, br)
    jbp, jbr = jeng.forward_kinematics(jm, js)
    jom, jvo = jeng._body_world_velocities(jm, js, jbr)
    sc = teng.self_collision_forces(tm, m["tp"], bp, br, om, vo, 0.0025)
    jsc = jeng.self_collision_forces(jm, m["jp"], jbp, jbr, jom, jvo, 0.0025)
    _close(sc, jsc, "self collision", rtol=1e-5, atol=1e-3)
    assert float(sc.abs().max()) > 1.0
    pairs = teng.contact_pairs(tm, m["tp"], ts)
    jpairs = jeng.contact_pairs(jm, m["jp"], js)
    for k in ("link_a", "link_b"):
        np.testing.assert_array_equal(pairs[k], jpairs[k], err_msg=k)
    _close(pairs["force"], jpairs["force"], "contact_pairs force", **CONTACT_TOL)
    assert pairs["valid"].any()


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_aba_matches_jax(models, per_env):
    m = models["g1"]
    tm, jm = m["tm"], m["jm"]
    n = 8
    rng = np.random.default_rng(3)
    ts, js, _ = _states(tm, n, seed=4, height=fx.G1_PELVIS_HEIGHT)
    _, br = teng.forward_kinematics(tm, ts)
    _, jbr = jeng.forward_kinematics(jm, js)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = dict(root_vel_b=f(n, 6), dof_vel=f(n, tm.nd), tau=10 * f(n, tm.nd),
                f_ext_w=30 * f(n, tm.nb, 6), implicit_damping=np.abs(f(tm.nd)) + 1.0)
    ms = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n)).astype(np.float32) if per_env else None
    jrot = teng.joint_rot_mats(tm, ts.dof_pos)
    _close(jrot, jeng.joint_rot_mats(jm, js.dof_pos), "joint_rot", rtol=1e-5, atol=1e-6)
    qdd, acc = taba.aba(tm, br, *(_t(args[k]) for k in ("root_vel_b", "dof_vel")), jrot,
                        _t(args["tau"]), _t(args["f_ext_w"]), _t(args["implicit_damping"]),
                        0.0025, ms=None if ms is None else _t(ms))
    jfn = jax.jit(lambda br_, rv, dv, jr, tau, fe, d, ms_: jaba.aba(
        jm, br_, rv, dv, jr, tau, fe, d, 0.0025, ms=ms_))
    jqdd, jacc = jfn(jbr, *(jnp.asarray(args[k]) for k in ("root_vel_b", "dof_vel")),
                     jeng.joint_rot_mats(jm, js.dof_pos),
                     *(jnp.asarray(args[k]) for k in ("tau", "f_ext_w", "implicit_damping")),
                     None if ms is None else jnp.asarray(ms))
    _close(qdd, jqdd, "qdd", rtol=1e-4, atol=1e-3)
    _close(acc, jacc, "root acc", rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------------- step


@pytest.mark.parametrize("which,per_env", [("mini", False), ("g1", False), ("g1", True)],
                         ids=["mini", "g1", "g1_per_env"])
def test_engine_step_matches_jax(models, which, per_env):
    m = models[which]
    tm, jm, tp, jp = m["tm"], m["jm"], m["tp"], m["jp"]
    n = 8
    ts, js, cmd = _states(tm, n, seed=5, height=m["height"])
    if per_env:
        pe = fx.per_env_params(tp.kp.numpy(), tp.kv.numpy(), n, seed=6)
        tp = dataclasses.replace(tp, **{k: _t(v) for k, v in pe.items()})
        jp = dataclasses.replace(jp, **{k: jnp.asarray(v) for k, v in pe.items()})
    j_state, j_contact = jax.jit(lambda p, s, c: jeng.step(jm, p, s, c))(jp, js, jnp.asarray(cmd))
    t_state, t_contact = teng.step(tm, tp, ts, _t(cmd))
    _assert_states_close(t_state, t_contact, j_state, j_contact)
    assert (t_contact > 0).any()


def test_engine_step_matches_fused_step_with_geoms(models, geoms):
    """The reference-layout engine and the env-minor plain step with the
    narrowphase tables attached, 3 control steps from a perturbed standing
    state with active pairs (the JAX package's own check of its two paths,
    tests/test_narrowphase.py, with its tolerances)."""
    tm, _ = geoms
    tp = models["g1"]["tp"]
    fc = FusedModelConstants(tm)
    ts, _, _ = _states(tm, 8, seed=7, height=fx.G1_PELVIS_HEIGHT, bend=0.2)
    np_ext = compute_np_ext(fc, tp, tp.ctrl_dt / tp.substeps, ts)
    assert max(float(n.abs().max()) for n, _ in np_ext.values()) > 10.0
    tgt = ts.dof_pos
    s_ref, s_fused = ts, ts
    for _ in range(3):
        s_ref, c_ref = teng.step(tm, tp, s_ref, tgt)
        s_fused, c_fused = fused_step(fc, tp, s_fused, tgt)
    for f in ("root_pos", "root_quat", "root_vel", "root_ang_vel", "dof_pos", "dof_vel"):
        _close(getattr(s_ref, f), getattr(s_fused, f).numpy(), f, rtol=0, atol=5e-4)
    _close(c_ref, c_fused.numpy(), "contact", rtol=0, atol=5e-2)


# --------------------------------------------------- held narrowphase wrenches


def test_compute_np_ext_matches_jax(models, geoms):
    tm, jm = geoms
    m = models["g1"]
    fc, jfc = FusedModelConstants(tm), JaxFMC(jm)
    ts, js, _ = _states(tm, 8, seed=8, height=fx.G1_PELVIS_HEIGHT, bend=0.2)
    dt = 0.0025
    got = compute_np_ext(fc, m["tp"], dt, ts)
    want = jax.jit(lambda p, s: jax_np_ext(jfc, p, dt, s))(m["jp"], js)
    assert sorted(got) == sorted(want) == fc.np_bodies.tolist()
    for b in got:
        for k, what in ((0, "torque"), (1, "force")):
            _close(got[b][k], want[b][k], f"{what} on body {b}", **WRENCH_TOL)
    assert max(float(f.abs().max()) for _, f in got.values()) > 10.0
    assert compute_np_ext(FusedModelConstants(m["tm"]), m["tp"], dt, ts) is None


def test_merge_ext_matches_jax():
    rng = np.random.default_rng(9)
    r = lambda: rng.normal(size=(3, 5)).astype(np.float32)
    a = {0: (r(), r()), 3: (r(), r())}
    b = {3: (r(), r()), 7: (r(), r())}
    to_t = lambda d: {k: (_t(n), _t(f)) for k, (n, f) in d.items()}
    to_j = lambda d: {k: (jnp.asarray(n), jnp.asarray(f)) for k, (n, f) in d.items()}
    got, want = merge_ext(to_t(a), to_t(b)), jax_merge_ext(to_j(a), to_j(b))
    assert sorted(got) == sorted(want) == [0, 3, 7]
    for k in got:
        for i in range(2):
            _close(got[k][i], want[k][i], f"body {k}", rtol=0, atol=0)
    assert merge_ext(None, to_t(b)).keys() == b.keys() and merge_ext(to_t(a), None).keys() == a.keys()


def test_fused_substep_with_geoms_matches_jax(models, geoms):
    tm, jm = geoms
    m = models["g1"]
    fc, jfc = FusedModelConstants(tm), JaxFMC(jm)
    ts, js, _ = _states(tm, 8, seed=10, height=fx.G1_PELVIS_HEIGHT, bend=0.2)
    dt = 0.0025
    j_state, j_contact = jax.jit(lambda p, s: jax_fused_substep(jfc, p, s, dt))(m["jp"], js)
    t_state, t_contact = fused_substep(fc, m["tp"], ts, dt)
    _assert_states_close(t_state, t_contact, j_state, j_contact)


# ---------------------------------------------------------- parity check


@pytest.fixture(scope="module")
def np_env(models, tmp_path_factory):
    from add_gym_torch.builder import build_env
    from add_gym_torch.utils.config import load_config

    d = tmp_path_factory.mktemp("parity")
    cfg = load_config("train")
    cfg["robot"]["asset_path"] = models["g1"]["path"]
    cfg["task"]["motion_file"] = fx.write_motion_csv(str(d / "clip.motion"), seed=1)
    cfg["engine"]["general_narrowphase"] = True
    return build_env(cfg, device="cpu")


def test_parity_check(np_env, monkeypatch):
    from add_gym_torch.utils.debug import parity_check

    assert np_env.fused and not np_env.kernel and np_env.model.geoms.num_pairs == 637
    errs = parity_check(np_env, n=4)
    assert set(errs) == {"root_pos", "root_quat", "dof_pos", "dof_vel"}
    assert max(errs.values()) < 5e-4
    # a backend that disagrees fails loudly, naming the field
    step = np_env._step_fn

    def off(p, s, t):
        s2, c = step(p, s, t)
        return dataclasses.replace(s2, dof_pos=s2.dof_pos + 1e-3), c

    monkeypatch.setattr(np_env, "_step_fn", off)
    with pytest.raises(AssertionError, match="dof_pos diverges"):
        parity_check(np_env, n=4)
    monkeypatch.setattr(np_env, "fused", False)
    assert parity_check(np_env) is None
