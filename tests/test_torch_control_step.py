"""Port parity: the physics control step.

* The port's plain step (``fused_step``) against the JAX Pallas kernel body
  (``pallas_step(..., interpret=True)``) on the mini biped (N=16, as
  tests/test_pallas_mini.py runs it), and against JAX ``fused_step`` on
  the G1-shaped fixture (N=8; the kernel's interpret mode would take tens
  of minutes there): free fall, ground contact and joint limits.
* The CUDA kernel's per-env device function (``csrc/control_step.cuh``),
  built with the host C++ compiler, against the plain step on both
  fixtures: the kernel's arithmetic, checked without a card.  The card
  runs it with a warp per env; the host runs it with a team of 1 lane and
  with 32 lanes emulated one after another (``AgtHostTeam``), and the two
  must agree bit for bit, main and per-env, with and without narrowphase
  rows.  A 32-body model (the narrow instance's most) by the 32-lane team
  matches the plain step too; so does the wide instance (48 body slots,
  64-bit child masks) on the G1 with Dex3-1 hands (44 bodies), by teams
  of 1 and 32, main and per-env; past 48 bodies a model is refused.
* The per-env variant (domain randomization: per-env ``kp``/``kv``
  ``[N, nd]``, friction ``[N]`` and mass scale ``[N]`` in [0.5, 2.0]): the
  plain step against the Pallas kernel body with ``use_ms`` (interpret
  mode, mini biped) and against JAX ``fused_step`` (G1-shaped fixture);
  the per-env device function (g++ build) against the plain step and
  against the Pallas kernel body; and, with shared values and ``ms = 1``,
  bit for bit against the main variant.
* The held narrowphase rows (``np_bodies``): the plain step with the
  G1-shaped fixture's geom tables against JAX ``fused_step`` with them;
  the device function with random rows fed directly against the Pallas
  kernel body with ``np_bodies`` (interpret mode, mini biped), with and
  without the mass scale; and with the rows of ``compute_np_ext`` against
  the plain step, main and per-env.
* ``cuda_step`` on CPU tensors is the plain step; ``build_env`` refuses a
  CUDA device where there is none.

The kernel itself runs against the plain step on a card in
tests/test_torch_cuda.py.

One-step tolerances are ``physics.testing.step_tolerances()`` (positions
1e-5; velocities atol 1e-4; contact atol 5e-2 N; see its docstring for
why).  Chained steps compound op-order differences through stiff contacts
and are held to rtol = atol = 1e-3 over 20 steps (measured: ~2e-5 on the
G1-shaped fixture in ground contact).
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.physics import engine as jeng
from add_gym_tpu.physics.fused_step import FusedModelConstants as JaxFMC
from add_gym_tpu.physics.fused_step import fused_step as jax_fused_step
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_tpu.physics.pallas_step import pallas_step
from add_gym_torch.physics import cuda_step as cs
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.engine import EngineParams, SimState
from add_gym_torch.physics.fused_step import FusedModelConstants, fused_step
from add_gym_torch.physics.model import build_physics_model
from add_gym_torch.robot import build_pd_gains
from port_bench.inputs import write_g1_dex3_fixture

torch.set_num_threads(2)

CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)


def _setup(path, g1):
    """(model, port constants, port params, JAX params, JAX step, JAX
    constants) for one fixture; the
    JAX step is jitted once: the Pallas kernel body in interpret mode on
    the mini biped, the JAX fused step on the G1-shaped fixture."""
    tmodel = build_physics_model(path)
    jmodel = jax_build_model(path)
    if g1:
        kp, kv = build_pd_gains(tmodel)
    else:
        kp = np.full(tmodel.nd, 50.0, np.float32)
        kv = np.full(tmodel.nd, 5.0, np.float32)
    tp = EngineParams(kp=torch.as_tensor(kp), kv=torch.as_tensor(kv))
    jp = jeng.EngineParams(kp=jnp.asarray(kp), kv=jnp.asarray(kv))
    jfc = JaxFMC(jmodel)
    if g1:
        jstep = jax.jit(lambda p, s, t: jax_fused_step(jfc, p, s, t))
    else:
        jstep = jax.jit(lambda p, s, t: pallas_step(jfc, p, s, t, interpret=True))
    return tmodel, FusedModelConstants(tmodel), tp, jp, jstep, jfc


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return _setup(fx.write_mini_mjcf(str(tmp_path_factory.mktemp("mini"))), g1=False)


@pytest.fixture(scope="module")
def g1(tmp_path_factory):
    return _setup(fx.write_g1_fixture(str(tmp_path_factory.mktemp("g1"))), g1=True)


@pytest.fixture(scope="module")
def g1_dex3(tmp_path_factory):
    """The G1 with Dex3-1 hands (the benchmark's topology stand-in: 44
    bodies, 43 hinges, 13 levels), with the JAX fused step as for the G1."""
    return _setup(write_g1_dex3_fixture(str(tmp_path_factory.mktemp("dex3"))), g1=True)


def _scenario(model, n, kind, height):
    """(fields, command) for one test scenario, from a numpy seed."""
    fields, cmd = fx.random_sim_state(model, n, seed=3, height=height)
    lo, hi = model.dof_limit[:, 0], model.dof_limit[:, 1]
    if kind == "free_fall":
        fields["root_pos"][:, 2] += 2.0
    elif kind == "joint_limits":
        # joints start 0.02 rad past alternate limits and move outward, so
        # the limit springs act (each substep clamps q back into range);
        # the command points past the limit
        side = np.where(np.arange(model.nd) % 2 == 0, 1.0, -1.0)
        edge = np.where(side > 0, hi, lo)
        fields["dof_pos"][:] = edge + 0.02 * side
        fields["dof_vel"][:] = 3.0 * side
        fields["pd_target"][:] = edge
        cmd[:] = edge + 0.3 * side
    return fields, cmd


def _both_states(fields):
    t = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    j = jeng.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return t, j


def _assert_step_close(t_state, t_contact, j_state, j_contact, tol=None):
    """Every output close; ``tol`` is one rtol/atol for all, or None for
    the per-output one-step tolerances."""
    tols = fx.step_tolerances() if tol is None else dict.fromkeys(fx.step_tolerances(), tol)
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)),
                                   err_msg=f, **tols[f])
    np.testing.assert_allclose(t_contact.numpy(), np.asarray(j_contact), err_msg="contact",
                               **tols["contact"])


SCENARIOS = ["free_fall", "ground_contact", "joint_limits"]


def _per_env_params(tp, jp, n, seed):
    """Per-env gains, friction and mass scale (``testing.per_env_params``)
    as port and JAX ``EngineParams``."""
    pe = fx.per_env_params(tp.kp.numpy(), tp.kv.numpy(), n, seed)
    t = dataclasses.replace(tp, **{k: torch.as_tensor(v) for k, v in pe.items()})
    j = dataclasses.replace(jp, **{k: jnp.asarray(v) for k, v in pe.items()})
    return t, j


@pytest.mark.parametrize("kind", SCENARIOS)
def test_mini_step_matches_pallas_kernel_body(mini, kind):
    model, fc, tp, jp, jstep, _ = mini
    fields, cmd = _scenario(model, 16, kind, height=0.6)
    ts, js = _both_states(fields)
    j_state, j_contact = jstep(jp, js, jnp.asarray(cmd))
    t_state, t_contact = fused_step(fc, tp, ts, torch.as_tensor(cmd))
    _assert_step_close(t_state, t_contact, j_state, j_contact)
    if kind == "free_fall":
        assert not np.asarray(j_contact).any()
    elif kind == "ground_contact":
        assert np.asarray(j_contact).any()


@pytest.mark.parametrize("kind", SCENARIOS)
def test_g1_fixture_step_matches_jax_fused(g1, kind):
    model, fc, tp, jp, jstep, _ = g1
    fields, cmd = _scenario(model, 8, kind, height=fx.G1_PELVIS_HEIGHT)
    ts, js = _both_states(fields)
    j_state, j_contact = jstep(jp, js, jnp.asarray(cmd))
    t_state, t_contact = fused_step(fc, tp, ts, torch.as_tensor(cmd))
    _assert_step_close(t_state, t_contact, j_state, j_contact)
    if kind == "free_fall":
        assert not np.asarray(j_contact).any()
    elif kind == "ground_contact":
        assert (np.asarray(j_contact) > 0).any()


@pytest.mark.parametrize("variant", ["main", "per_env"])
@pytest.mark.parametrize("kind", SCENARIOS)
def test_g1_dex3_step_matches_jax_fused(host_kernel, g1_dex3, kind, variant):
    """The G1 with Dex3-1 hands (44 bodies, 13 levels, 360 ground points)
    against the JAX fused step: the plain step, and the kernel's wide
    instance built for the host by teams of 1 and 32 lanes, main and
    per-env variant."""
    model, fc, tp, jp, jstep, _ = g1_dex3
    n = 8
    fields, cmd = _scenario(model, n, kind, height=fx.G1_PELVIS_HEIGHT)
    if variant == "per_env":
        tp, jp = _per_env_params(tp, jp, n, seed=12)
    ts, js = _both_states(fields)
    j_state, j_contact = jstep(jp, js, jnp.asarray(cmd))
    cmd = torch.as_tensor(cmd)
    _assert_step_close(*fused_step(fc, tp, ts, cmd), j_state, j_contact)
    for team in (1, 32):
        _assert_step_close(*_host_step(host_kernel, fc, tp, ts, cmd, team=team), j_state, j_contact)
    if kind == "free_fall":
        assert not np.asarray(j_contact).any()
    elif kind == "ground_contact":
        assert (np.asarray(j_contact) > 0).any()


@pytest.mark.parametrize("which", ["mini", "g1", "g1_dex3"])
def test_per_env_step_matches_jax(request, which):
    """Mini biped: the Pallas kernel body with ``use_ms``; G1-shaped
    fixture and the G1 with Dex3-1 hands: JAX ``fused_step``.  All with
    per-env params, in contact."""
    model, fc, tp, jp, jstep, _ = request.getfixturevalue(which)
    n = 16 if which == "mini" else 8
    height = 0.6 if which == "mini" else fx.G1_PELVIS_HEIGHT
    fields, cmd = _scenario(model, n, "ground_contact", height)
    tpe, jpe = _per_env_params(tp, jp, n, seed=12)
    ts, js = _both_states(fields)
    j_state, j_contact = jstep(jpe, js, jnp.asarray(cmd))
    t_state, t_contact = fused_step(fc, tpe, ts, torch.as_tensor(cmd))
    _assert_step_close(t_state, t_contact, j_state, j_contact)
    assert (np.asarray(j_contact) > 0).any()
    # the per-env values matter: the shared-parameter step differs
    s_state, s_contact = fused_step(fc, tp, ts, torch.as_tensor(cmd))
    assert not torch.allclose(s_state.dof_vel, t_state.dof_vel, rtol=1e-3, atol=1e-3)
    assert not torch.allclose(s_contact, t_contact, rtol=1e-3, atol=1e-1)


def test_mass_scale_applies_after_self_collision(g1):
    """The held self-collision wrenches enter before the mass scale: with
    legs crossed (non-zero wrenches) and ``ms = 2`` the plain step matches
    JAX."""
    from add_gym_torch.physics.fused_step import compute_sc_ext

    model, fc, tp, jp, jstep, _ = g1
    fields, cmd = fx.random_sim_state(model, 8, seed=6, height=fx.G1_PELVIS_HEIGHT)
    for j, name in enumerate(model.joint_names):
        if "hip_roll" in name:
            fields["dof_pos"][:, j] = -0.35 if name.startswith("left") else 0.35
    ts, js = _both_states(fields)
    tpe = dataclasses.replace(tp, mass_scale=torch.full((8,), 2.0))
    jpe = dataclasses.replace(jp, mass_scale=jnp.full((8,), 2.0))
    j_state, j_contact = jstep(jpe, js, jnp.asarray(cmd))
    t_state, t_contact = fused_step(fc, tpe, ts, torch.as_tensor(cmd))
    _assert_step_close(t_state, t_contact, j_state, j_contact)
    assert (t_contact > 0).any()
    assert float(compute_sc_ext(fc, tp, tp.ctrl_dt / tp.substeps, ts)[1].abs().max()) > 1.0


def _chain(fixture, fields, cmd, in_contact, steps=20):
    model, fc, tp, jp, jstep, _ = fixture
    ts, js = _both_states(fields)
    tcmd, jcmd = torch.as_tensor(cmd), jnp.asarray(cmd)
    for _ in range(steps):
        js, jc = jstep(jp, js, jcmd)
        ts, tc = fused_step(fc, tp, ts, tcmd)
    assert (np.asarray(jc) > 0).any() == in_contact
    _assert_step_close(ts, tc, js, jc, CHAIN_TOL)


def test_mini_chained_steps_match_pallas_kernel_body(mini):
    """20 control steps in the air: PD-driven legs swinging into their
    limits.  (Standing on its two hinged legs the mini biped is chaotic:
    the JAX package's own fused step and Pallas kernel body drift apart by
    ~6e-2 within 20 steps, so no chained comparison in contact can hold.)"""
    model = mini[0]
    fields, cmd = fx.random_sim_state(model, 16, seed=4, height=3.0)
    cmd = 2.0 * cmd                                 # some commands past the limits
    _chain(mini, fields, cmd, in_contact=False)


def test_g1_fixture_chained_steps_match_jax_fused(g1):
    fields, cmd = fx.random_sim_state(g1[0], 8, seed=5, height=fx.G1_PELVIS_HEIGHT)
    _chain(g1, fields, cmd, in_contact=True)


def test_held_self_collision_forces_match_jax(g1):
    """The held self-collision wrenches of a crossed-legs state equal the
    JAX package's, are non-zero, and change the step when switched off."""
    from add_gym_tpu.physics.fused_step import compute_sc_ext as jax_sc_ext
    from add_gym_torch.physics.fused_step import compute_sc_ext

    model, fc, tp, jp, _, jfc = g1
    fields, cmd = fx.random_sim_state(model, 8, seed=6, height=fx.G1_PELVIS_HEIGHT)
    fields["dof_pos"][:, :] = 0.0
    # hip roll inward on both sides brings the legs together
    for j, name in enumerate(model.joint_names):
        if "hip_roll" in name:
            fields["dof_pos"][:, j] = -0.35 if name.startswith("left") else 0.35
    ts, js = _both_states(fields)
    dt = tp.ctrl_dt / tp.substeps
    n_t, f_t = compute_sc_ext(fc, tp, dt, ts)
    want = jax_sc_ext(jfc, jp, dt, js)
    zero = np.zeros((3, 8), np.float32)
    for b in range(model.nb):
        n_j, f_j = want.get(b, (zero, zero))
        np.testing.assert_allclose(n_t[b].numpy(), np.asarray(n_j), rtol=1e-5, atol=1e-4,
                                   err_msg=f"torque on body {b}")
        np.testing.assert_allclose(f_t[b].numpy(), np.asarray(f_j), rtol=1e-5, atol=1e-3,
                                   err_msg=f"force on body {b}")
    assert float(f_t.abs().max()) > 1.0

    on, _ = fused_step(fc, tp, ts, torch.as_tensor(cmd))
    off, _ = fused_step(fc, dataclasses.replace(tp, self_collision=False), ts, torch.as_tensor(cmd))
    assert not torch.allclose(on.dof_vel, off.dof_vel)


def test_cuda_step_on_cpu_is_the_plain_step(mini):
    model, fc, tp = mini[:3]
    fields, cmd = fx.random_sim_state(model, 16, seed=8, height=0.6)
    ts = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    before = cs.cuda_step.launches
    s1, c1 = cs.cuda_step(fc, tp, ts, torch.as_tensor(cmd))
    s2, c2 = fused_step(fc, tp, ts, torch.as_tensor(cmd))
    assert cs.cuda_step.launches == before        # no kernel launch on the CPU
    for f in fx.STATE_FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    assert torch.equal(c1, c2)


def test_kernel_refuses_cpu_tensors(mini):
    model, fc, tp = mini[:3]
    fields, cmd = fx.random_sim_state(model, 4, seed=9, height=0.6)
    ts = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    with pytest.raises(ValueError, match="CUDA"):
        cs.launch_control_step(fc, tp, cs.pack_state(ts, torch.as_tensor(cmd)))


def test_build_env_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from add_gym_torch.builder import build_env
    from add_gym_torch.utils.config import load_config

    cfg = load_config("train")
    cfg["robot"]["asset_path"] = fx.write_g1_fixture(str(tmp_path))
    cfg["task"]["motion_file"] = fx.write_motion_csv(str(tmp_path / "c.motion"), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_env(cfg, device="cuda")
    cfg["engine"]["kernel"] = "on"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        build_env(cfg, device="cpu")


# ---------------------------------------------- the kernel's device function

_SHIM = r"""
#include "control_step.cuh"
// the per-env step over all n envs by a host team of kTeam lanes, with the
// scratch of the kernel's instance of body capacity kCap
template <bool kPerEnv, int kTeam, int kCap>
static void run(const float* f, const int* ib, int nb, int nd, int ncp, int nsph, int npair,
                int substeps, int n_np, const float* in, float* out, int n) {
  AgtModel m{f, ib, nb, nd, ncp, nsph, npair, substeps, n_np};
  AgtEnvScratch<kCap> s;
  for (int e = 0; e < n; ++e) agt_control_step_env<kPerEnv>(AgtHostTeam<kTeam>(), m, s, in, out, n, e);
}
#define AGT_ENTRY(name, per_env, team, cap)                                                   \
  extern "C" void name(const float* f, const int* ib, int nb, int nd, int ncp, int nsph,     \
                       int npair, int substeps, int n_np, const float* in, float* out, int n) { \
    run<per_env, team, cap>(f, ib, nb, nd, ncp, nsph, npair, substeps, n_np, in, out, n);     \
  }
AGT_ENTRY(agt_control_step_host, false, 1, 32)
AGT_ENTRY(agt_control_step_dr_host, true, 1, 32)
AGT_ENTRY(agt_control_step_host32, false, 32, 32)
AGT_ENTRY(agt_control_step_dr_host32, true, 32, 32)
AGT_ENTRY(agt_control_step_host_w48, false, 1, 48)
AGT_ENTRY(agt_control_step_dr_host_w48, true, 1, 48)
AGT_ENTRY(agt_control_step_host32_w48, false, 32, 48)
AGT_ENTRY(agt_control_step_dr_host32_w48, true, 32, 48)
"""

# the shim's entry points: (per-env variant, team size, body capacity)
_HOST_ENTRIES = {
    (per_env, team, cap): "agt_control_step" + ("_dr" if per_env else "") + "_host"
    + ("32" if team == 32 else "") + ("" if cap == 32 else f"_w{cap}")
    for per_env in (False, True) for team in (1, 32) for cap in cs.INSTANCES
}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernel")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    lib_path = d / "libhost_control_step.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", cs.CSRC_DIR, "-o", str(lib_path),
         str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name in _HOST_ENTRIES.values():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
        )
    return lib


def _host_out(host_kernel, fc, params, inp, per_env, team=1):
    """The output block of one control step by the device function built
    for the host, stepped by a host team of ``team`` lanes (1 or 32) with
    the scratch of the instance ``cuda_step`` picks for the model."""
    n = inp.shape[1]
    fbuf, ibuf, counts = cs.pack_model(fc, params, per_env)
    out = torch.empty((13 + 3 * fc.nd + fc.nb, n))
    name = _HOST_ENTRIES[(bool(per_env), team, cs.instance(fc.nb))]
    getattr(host_kernel, name)(fbuf.ctypes.data, ibuf.ctypes.data, *counts, inp.data_ptr(),
                               out.data_ptr(), n)
    return out


def _host_step(host_kernel, fc, params, state, cmd, team=1):
    """One control step by the device function built for the host: the
    per-env variant for per-env ``params``, else the main one."""
    inp = cs.pack_state(state, cmd, params)
    per_env = inp.shape[0] == 15 + 6 * fc.nd
    return cs.unpack_state(_host_out(host_kernel, fc, params, inp, per_env, team), fc.nd)


@pytest.mark.parametrize("kind", ["ground_contact", "joint_limits"])
@pytest.mark.parametrize("which", ["mini", "g1"])
def test_device_function_matches_plain_step(host_kernel, mini, g1, which, kind):
    model, fc, tp = (mini if which == "mini" else g1)[:3]
    height = 0.6 if which == "mini" else fx.G1_PELVIS_HEIGHT
    n = 37                                            # not a multiple of anything
    fields, cmd = _scenario(model, n, kind, height)
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    fbuf, ibuf, counts = cs.pack_model(fc, tp)
    for _ in range(4):
        inp = cs.pack_state(state, cmd)
        out = torch.empty((13 + 3 * model.nd + model.nb, n))
        host_kernel.agt_control_step_host(
            fbuf.ctypes.data, ibuf.ctypes.data, *counts, inp.data_ptr(), out.data_ptr(), n)
        k_state, k_contact = cs.unpack_state(out, model.nd)
        p_state, p_contact = fused_step(fc, tp, state, cmd)
        for f, tol in fx.step_tolerances().items():
            got = k_contact if f == "contact" else getattr(k_state, f)
            want = p_contact if f == "contact" else getattr(p_state, f)
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{f}: {m}")
        if kind == "ground_contact":
            assert (p_contact > 0).any()
        state = p_state


@pytest.mark.parametrize("kind", ["ground_contact", "joint_limits"])
@pytest.mark.parametrize("which", ["mini", "g1"])
def test_per_env_device_function_matches_plain_step(host_kernel, mini, g1, which, kind):
    model, fc, tp, jp = (mini if which == "mini" else g1)[:4]
    height = 0.6 if which == "mini" else fx.G1_PELVIS_HEIGHT
    n = 37
    fields, cmd = _scenario(model, n, kind, height)
    tpe = _per_env_params(tp, jp, n, seed=13)[0]
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    for _ in range(4):
        k_state, k_contact = _host_step(host_kernel, fc, tpe, state, cmd)
        p_state, p_contact = fused_step(fc, tpe, state, cmd)
        _assert_step_close(k_state, k_contact, p_state, p_contact)
        if kind == "ground_contact":
            assert (p_contact > 0).any()
        state = p_state


def test_per_env_device_function_matches_pallas_kernel_body(host_kernel, mini):
    """The Pallas kernel with ``use_ms`` (interpret mode) and the per-env
    device function on the same per-env inputs, mini biped in contact."""
    model, fc, tp, jp, jstep, _ = mini
    fields, cmd = _scenario(model, 16, "ground_contact", 0.6)
    tpe, jpe = _per_env_params(tp, jp, 16, seed=14)
    ts, js = _both_states(fields)
    j_state, j_contact = jstep(jpe, js, jnp.asarray(cmd))
    k_state, k_contact = _host_step(host_kernel, fc, tpe, ts, torch.as_tensor(cmd))
    _assert_step_close(k_state, k_contact, j_state, j_contact)
    assert (np.asarray(j_contact) > 0).any()


def test_per_env_variant_with_shared_values_is_the_main_variant(host_kernel, g1):
    """Shared gains and friction broadcast into the per-env rows and ms = 1
    give the main variant's result bit for bit (x * 1.0f is exact)."""
    model, fc, tp = g1[:3]
    n = 19
    fields, cmd = _scenario(model, n, "ground_contact", fx.G1_PELVIS_HEIGHT)
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    bcast = dataclasses.replace(
        tp, kp=tp.kp[None].expand(n, -1).contiguous(), kv=tp.kv[None].expand(n, -1).contiguous(),
        friction_mu=torch.full((n,), float(tp.friction_mu)))
    a_state, a_contact = _host_step(host_kernel, fc, tp, state, cmd)
    b_state, b_contact = _host_step(host_kernel, fc, bcast, state, cmd)
    for f in fx.STATE_FIELDS:
        assert torch.equal(getattr(a_state, f), getattr(b_state, f)), f
    assert torch.equal(a_contact, b_contact) and (a_contact > 0).any()


NP_BODIES = dict(mini=[0, 2], g1=[0, 4, 9, 17, 23, 29], g1_dex3=[0, 4, 9, 17, 23, 29, 33, 43])


@pytest.mark.parametrize("rows", ["no_np", "np"])
@pytest.mark.parametrize("variant", ["main", "per_env"])
@pytest.mark.parametrize("which", ["mini", "g1", "g1_dex3"])
def test_team_sizes_agree_bitwise(host_kernel, request, which, variant, rows):
    """The step by a host team of 32 lanes (each phase run for lanes 31..0
    in turn) gives the bits of a team of 1, over 3 chained steps at N = 37:
    every phase's items are independent and every sum across lanes runs in
    a fixed order.  With ``np``, random held narrowphase rows on a few
    bodies (the mini biped's 0 and 2, six bodies of the G1-shaped fixture,
    eight of the G1 with Dex3-1 hands, two of them fingers past lane 31).
    On the 44-body robot the wide instance runs, lanes 0-11 with two bodies."""
    model, fc, tp, jp = request.getfixturevalue(which)[:4]
    height = 0.6 if which == "mini" else fx.G1_PELVIS_HEIGHT
    n = 37
    fields, cmd = _scenario(model, n, "ground_contact", height)
    per_env = variant == "per_env"
    if per_env:
        tp = _per_env_params(tp, jp, n, seed=26)[0]
    extra = None
    if rows == "np":
        fc = FusedModelConstants(model)
        fc.np_bodies = np.array(NP_BODIES[which])
        extra = torch.as_tensor(np.random.default_rng(27).normal(
            0.0, 20.0, (6 * len(fc.np_bodies), n)).astype(np.float32))
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    for _ in range(3):
        inp = cs.pack_state(state, cmd, tp, per_env)
        if extra is not None:
            inp = torch.cat([inp, extra])
        one = _host_out(host_kernel, fc, tp, inp, per_env, team=1)
        many = _host_out(host_kernel, fc, tp, inp, per_env, team=32)
        assert torch.equal(one, many)
        state, contact = cs.unpack_state(one, model.nd)
        assert torch.isfinite(one).all() and (contact > 0).any()


@pytest.mark.parametrize("team", [1, 32])
@pytest.mark.parametrize("variant", ["main", "per_env"])
@pytest.mark.parametrize("kind", ["ground_contact", "joint_limits"])
def test_wide_instance_matches_plain_step(host_kernel, g1_dex3, kind, variant, team):
    """The kernel's wide instance (48 body slots, 64-bit child masks), built
    for the host, on the G1 with Dex3-1 hands (44 bodies, 13 levels) by a
    team of 1 and of 32 lanes against the plain step, 3 chained steps at
    N = 37, main and per-env variant."""
    model, fc, tp, jp = g1_dex3[:4]
    assert (model.nb, model.nd, cs.instance(model.nb)) == (44, 43, 48)
    n = 37
    fields, cmd = _scenario(model, n, kind, fx.G1_PELVIS_HEIGHT)
    if variant == "per_env":
        tp = _per_env_params(tp, jp, n, seed=28)[0]
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    for _ in range(3):
        k_state, k_contact = _host_step(host_kernel, fc, tp, state, cmd, team=team)
        p_state, p_contact = fused_step(fc, tp, state, cmd)
        _assert_step_close(k_state, k_contact, p_state, p_contact)
        if kind == "ground_contact":
            assert (p_contact > 0).any()
        state = p_state


def test_wide_model_device_function_matches_plain_step(host_kernel, tmp_path):
    """A model of 32 bodies (the G1-shaped fixture with two hinged hands,
    tree depth 11), the narrow instance's most, by a host team of 32 lanes
    against the plain step, 2 chained steps.  Past it the wide instance
    takes a model, up to its 48 bodies; 49 are refused, and the child
    masks refuse a tree of more than 64 bodies."""
    model = build_physics_model(fx.write_wide_fixture(str(tmp_path), 2))
    assert model.nb == 32 and cs.instance(model.nb) == 32
    fc = FusedModelConstants(model)
    tp = EngineParams(kp=torch.full((model.nd,), 50.0), kv=torch.full((model.nd,), 5.0))
    fields, cmd = _scenario(model, 37, "ground_contact", fx.G1_PELVIS_HEIGHT)
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    for _ in range(2):
        k_state, k_contact = _host_step(host_kernel, fc, tp, state, cmd, team=32)
        p_state, p_contact = fused_step(fc, tp, state, cmd)
        _assert_step_close(k_state, k_contact, p_state, p_contact)
        assert (p_contact > 0).any()
        state = p_state
    assert cs.instance(33) == cs.instance(48) == 48
    with pytest.raises(ValueError, match="at most 48"):
        cs.instance(49)
    widest = build_physics_model(fx.write_wide_fixture(str(tmp_path), 35))
    assert widest.nb == 65
    with pytest.raises(ValueError, match="at most 64"):
        cs.pack_model(FusedModelConstants(widest), EngineParams(
            kp=torch.full((widest.nd,), 50.0), kv=torch.full((widest.nd,), 5.0)))


def test_per_env_input_block_layout(g1):
    model, fc, tp, jp = g1[:4]
    n, nd = 5, model.nd
    fields, cmd = fx.random_sim_state(model, n, seed=15, height=fx.G1_PELVIS_HEIGHT)
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    tpe = _per_env_params(tp, jp, n, seed=16)[0]
    inp = cs.pack_state(state, torch.as_tensor(cmd), tpe)
    assert tuple(inp.shape) == (15 + 6 * nd, n) and inp.is_contiguous()
    base = 13 + 4 * nd
    assert torch.equal(inp[base: base + nd], tpe.kp.T)
    assert torch.equal(inp[base + nd: base + 2 * nd], tpe.kv.T)
    assert torch.equal(inp[base + 2 * nd], tpe.friction_mu)
    assert torch.equal(inp[base + 2 * nd + 1], tpe.mass_scale)
    # without a mass scale the ms row is 1; the shared block stays as it was
    no_ms = dataclasses.replace(tpe, mass_scale=1.0)
    assert torch.equal(cs.pack_state(state, torch.as_tensor(cmd), no_ms)[-1], torch.ones(n))
    assert cs.pack_state(state, torch.as_tensor(cmd), tp).shape[0] == 13 + 4 * nd
    # per-env values never reach the cached model buffer (dof rows kp, kv)
    fbuf = cs.pack_model(fc, tpe)[0]
    dof_start = cs.HDR + model.nb * cs.BODY
    assert not fbuf[dof_start + 5 * nd: dof_start + 7 * nd].any()


def test_pack_model_layout(g1):
    model, fc, tp = g1[:3]
    fbuf, ibuf, counts = cs.pack_model(fc, tp)
    nb, nd, ncp, nsph, npair, substeps, n_np = counts
    assert (nb, nd, ncp, substeps, n_np) == (model.nb, model.nd, model.ncp, 4, 0)
    assert fbuf.size == cs.HDR + nb * cs.BODY + nd * cs.DOF + ncp * cs.PT + nsph * cs.SPH + npair * cs.PAIR
    # the child masks' bits 32-63 (nb words, zero for 30 bodies) after the pairs
    assert ibuf.size == nb + (nb + 1) + nb + (nb + 1) + nsph + 2 * npair + nb
    assert not ibuf[-nb:].any()
    # field-major: row k of the body section holds constant k of every body
    np.testing.assert_array_equal(fbuf[cs.HDR + 51 * nb: cs.HDR + 52 * nb], fc.mass)
    parent, depth = ibuf[:nb], ibuf[nb: 2 * nb + 1]
    children = ibuf[2 * nb + 1: 3 * nb + 1].view(np.uint32)
    assert depth[0] == 0 and depth[-1] == depth[:nb].max() == 10   # waist 3 + arm 7
    for i in range(1, nb):
        assert depth[i] == depth[parent[i]] + 1
        assert children[parent[i]] >> i & 1
    assert sum(bin(int(c)).count("1") for c in children) == nb - 1
    cp_start = ibuf[3 * nb + 1: 4 * nb + 2]
    assert cp_start[0] == 0 and cp_start[-1] == ncp and (np.diff(cp_start) >= 0).all()
    dof_start = cs.HDR + nb * cs.BODY
    kp = fbuf[dof_start + 5 * nd: dof_start + 6 * nd]
    np.testing.assert_array_equal(kp, tp.kp.numpy())
    no_sc = cs.pack_model(fc, dataclasses.replace(tp, self_collision=False))[2]
    assert no_sc[4] == 0


def test_pack_model_wide_masks(g1_dex3):
    """The 44-body tree's child masks span both words: each body's bit in
    its parent's 64-bit mask (bodies 32-43 in the high word), one bit a
    body but the root, 13 levels (waist 3 + arm 7 + thumb 3)."""
    model, fc, tp = g1_dex3[:3]
    fbuf, ibuf, counts = cs.pack_model(fc, tp)
    nb = counts[0]
    assert nb == 44 and ibuf.size == nb + (nb + 1) + nb + (nb + 1) + counts[3] + 2 * counts[4] + nb
    parent, depth = ibuf[:nb], ibuf[nb: 2 * nb + 1]
    words = np.stack([ibuf[2 * nb + 1: 3 * nb + 1], ibuf[-nb:]]).view(np.uint32).astype(np.uint64)
    masks = words[0] | words[1] << np.uint64(32)
    assert depth[-1] == depth[:nb].max() == 13
    for i in range(1, nb):
        assert depth[i] == depth[parent[i]] + 1
        assert int(masks[parent[i]]) >> i & 1
    assert sum(bin(int(c)).count("1") for c in masks) == nb - 1
    assert words[1].any()
    np.testing.assert_array_equal(cs.tree_tables(parent)[1], masks)


# ------------------------------------------------- held narrowphase rows


@pytest.fixture(scope="module")
def g1_geoms(g1, tmp_path_factory):
    """The G1-shaped fixture with its narrowphase tables attached, in both
    packages: (model, port constants, port params, JAX params, JAX fused
    step with geoms)."""
    from add_gym_tpu.physics.model import attach_geoms as jax_attach_geoms
    from add_gym_torch.physics.model import attach_geoms

    path = fx.write_g1_fixture(str(tmp_path_factory.mktemp("g1_geoms")))
    tmodel = attach_geoms(build_physics_model(path), path)
    jfc = JaxFMC(jax_attach_geoms(jax_build_model(path), path))
    jstep = jax.jit(lambda p, s, t: jax_fused_step(jfc, p, s, t))
    return tmodel, FusedModelConstants(tmodel), g1[2], g1[3], jstep


def _bent_scenario(model, n, seed):
    """Ground contact with joints bent by 0.2 N(0, 1): narrowphase pairs
    active (tests/test_narrowphase.py's perturbed standing state)."""
    fields, cmd = fx.random_sim_state(model, n, seed=seed, height=fx.G1_PELVIS_HEIGHT)
    rng = np.random.default_rng(seed)
    fields["dof_pos"] = np.clip(fields["dof_pos"] + 0.2 * rng.normal(size=fields["dof_pos"].shape),
                                model.dof_limit[:, 0], model.dof_limit[:, 1]).astype(np.float32)
    return fields, cmd


def test_g1_fixture_step_with_geoms_matches_jax_fused(g1_geoms):
    from add_gym_torch.physics.fused_step import compute_np_ext

    model, fc, tp, jp, jstep = g1_geoms
    fields, cmd = _bent_scenario(model, 8, seed=21)
    ts, js = _both_states(fields)
    j_state, j_contact = jstep(jp, js, jnp.asarray(cmd))
    t_state, t_contact = fused_step(fc, tp, ts, torch.as_tensor(cmd))
    _assert_step_close(t_state, t_contact, j_state, j_contact)
    np_ext = compute_np_ext(fc, tp, tp.ctrl_dt / tp.substeps, ts)
    assert max(float(f.abs().max()) for _, f in np_ext.values()) > 10.0
    # the held wrenches matter: without the tables the step differs
    plain, _ = fused_step(FusedModelConstants(dataclasses.replace(model, geoms=None)), tp, ts,
                          torch.as_tensor(cmd))
    assert not torch.allclose(plain.dof_vel, t_state.dof_vel, rtol=1e-3, atol=1e-3)


def _pallas_with_np_rows(jfc, jp, js, cmd, np_bodies, rows, use_ms):
    """The JAX Pallas kernel body (interpret mode) with ``np_bodies`` and
    their held-wrench ``rows`` [6 n, N] fed directly, as ``pallas_step``
    assembles its inputs."""
    from add_gym_tpu.physics.fused_step import _dof_tables, _prep_params
    from add_gym_tpu.physics.pallas_step import _build_call

    n, nd = cmd.shape
    kp, kv, mu = _prep_params(jfc, jp)
    mu = jnp.full((1, n), mu) if mu.ndim == 0 else mu.reshape(1, n)
    args = [js.root_pos.T, js.root_quat.T, js.root_vel.T, js.root_ang_vel.T, js.dof_pos.T,
            js.dof_vel.T, js.pd_target.T, jnp.asarray(cmd).T, jnp.broadcast_to(kp, (nd, n)),
            jnp.broadcast_to(kv, (nd, n)), mu,
            *(jnp.broadcast_to(t, (nd, n)) for t in _dof_tables(jfc))]
    if use_ms:
        args.append(jnp.asarray(jp.mass_scale).reshape(1, n))
    args.append(jnp.asarray(rows))
    call = _build_call(jfc, jp, n, n, interpret=True, use_ms=use_ms, np_bodies=tuple(np_bodies))
    rp, rq, rv, ra, q, qd, tgt, contact = call(*args)
    state = jeng.SimState(root_pos=rp.T, root_quat=rq.T, root_vel=rv.T, root_ang_vel=ra.T,
                          dof_pos=q.T, dof_vel=qd.T, pd_target=tgt.T)
    return state, contact.T


@pytest.mark.parametrize("use_ms", [False, True], ids=["main", "per_env_ms"])
def test_np_rows_device_function_matches_pallas_kernel_body(host_kernel, mini, use_ms):
    """Random narrowphase rows fed straight into both kernels on the mini
    biped (no geometry needed to test what a kernel does with the rows):
    the g++-built device function against the Pallas kernel body with
    ``np_bodies`` (interpret mode), with and without the mass scale."""
    model, fc, tp, jp, _, jfc = mini
    n = 16
    fields, cmd = _scenario(model, n, "ground_contact", 0.6)
    if use_ms:
        tp, jp = _per_env_params(tp, jp, n, seed=22)
    bodies = np.array([0, 2])
    rows = (np.random.default_rng(23).normal(0.0, 20.0, (6 * len(bodies), n))).astype(np.float32)
    ts, js = _both_states(fields)
    j_state, j_contact = _pallas_with_np_rows(jfc, jp, js, cmd, bodies, rows, use_ms)

    fc_np = FusedModelConstants(model)
    fc_np.np_bodies = bodies
    fbuf, ibuf, counts = cs.pack_model(fc_np, tp)
    assert counts[-1] == 2 and list(ibuf[-2:]) == [0, 2]
    inp = torch.cat([cs.pack_state(ts, torch.as_tensor(cmd), tp), torch.as_tensor(rows)])
    out = torch.empty((13 + 3 * model.nd + model.nb, n))
    fn = host_kernel.agt_control_step_dr_host if use_ms else host_kernel.agt_control_step_host
    fn(fbuf.ctypes.data, ibuf.ctypes.data, *counts, inp.data_ptr(), out.data_ptr(), n)
    k_state, k_contact = cs.unpack_state(out, model.nd)
    _assert_step_close(k_state, k_contact, j_state, j_contact)
    assert (np.asarray(j_contact) > 0).any()
    # the rows act: without them the kernel body's step differs
    zero_state, _ = _pallas_with_np_rows(jfc, jp, js, cmd, bodies, 0 * rows, use_ms)
    assert not np.allclose(np.asarray(zero_state.dof_vel), k_state.dof_vel.numpy(), atol=1e-3)


@pytest.mark.parametrize("per_env", [False, True], ids=["main", "per_env"])
def test_np_rows_device_function_matches_plain_step(host_kernel, g1_geoms, per_env):
    """The g++-built device function with the rows of ``compute_np_ext``
    against the port's plain step, 4 chained steps on the G1-shaped
    fixture with its tables attached (30 touched bodies, 180 rows)."""
    from add_gym_torch.physics.fused_step import compute_np_ext

    model, fc, tp, jp, _ = g1_geoms
    n = 37
    fields, cmd = _bent_scenario(model, n, seed=24)
    if per_env:
        tp = _per_env_params(tp, jp, n, seed=25)[0]
    state = SimState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    cmd = torch.as_tensor(cmd)
    for _ in range(4):
        np_ext = compute_np_ext(fc, tp, tp.ctrl_dt / tp.substeps, state)
        fbuf, ibuf, counts = cs.pack_model(fc, tp)
        inp = cs.pack_state(state, cmd, tp, None, np_ext)
        assert inp.shape[0] == (15 + 6 * model.nd if per_env else 13 + 4 * model.nd) + 180
        out = torch.empty((13 + 3 * model.nd + model.nb, n))
        fn = host_kernel.agt_control_step_dr_host if per_env else host_kernel.agt_control_step_host
        fn(fbuf.ctypes.data, ibuf.ctypes.data, *counts, inp.data_ptr(), out.data_ptr(), n)
        k_state, k_contact = cs.unpack_state(out, model.nd)
        p_state, p_contact = fused_step(fc, tp, state, cmd)
        _assert_step_close(k_state, k_contact, p_state, p_contact)
        state = p_state
