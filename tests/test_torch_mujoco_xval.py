"""The port's engine against CPU MuJoCo through the port's harness
(``physics/mujoco_xval.py``), beside the JAX engine through the JAX
package's harness, from the same initial state on the mini biped.

Two scenarios of tests/test_mujoco_xval.py, which needs the G1 assets:
free fall with no PD and no contact (30 control steps), and a PD hold of
the zero pose in the air (50 control steps).  Each engine's largest dof
and root-position error against MuJoCo must lie in the JAX test's
envelope (1e-6 rad, 1e-4 m), and the port's error may differ from the JAX
engine's by at most 1e-4.  The two harnesses must step MuJoCo to the same
state bit for bit.
"""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from add_gym_tpu.physics import engine as jeng
from add_gym_tpu.physics import mujoco_xval as jxval
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_torch.physics import engine as teng
from add_gym_torch.physics import mujoco_xval as txval
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.model import build_physics_model

torch.set_num_threads(2)

DOF_ENVELOPE, ROOT_ENVELOPE, GAP = 1e-6, 1e-4, 1e-4


def _errors(xval, mj, state, step, kp, kv, steps, nd):
    """Step the engine and MuJoCo side by side; (dof error, root error)."""
    s0 = {f: np.asarray(getattr(state, f))[0] for f in fx.STATE_FIELDS}
    xval.set_mj_state(mj, s0["root_pos"], s0["root_quat"], s0["root_vel"],
                      s0["root_ang_vel"], s0["dof_pos"], s0["dof_vel"],
                      pd_target=s0["pd_target"])
    target = np.zeros(nd)
    for _ in range(steps):
        state = step(state)
        xval.mj_control_step(mj, kp, kv, target)
    m = xval.get_mj_state(mj)
    dof = float(np.abs(np.asarray(state.dof_pos[0]) - m["dof_pos"]).max())
    root = float(np.linalg.norm(np.asarray(state.root_pos[0]) - m["root_pos"]))
    return dof, root, m


@pytest.mark.parametrize("scenario,steps", [("free_fall", 30), ("pd_hold", 50)])
def test_engine_against_mujoco_like_jax(tmp_path, scenario, steps):
    mjcf = fx.write_mini_mjcf(str(tmp_path))
    tmodel, jmodel = build_physics_model(mjcf), jax_build_model(mjcf)
    nd = tmodel.nd
    gain = 0.0 if scenario == "free_fall" else 1.0
    kp, kv = np.full(nd, 50.0 * gain), np.full(nd, 5.0 * gain)

    tparams = teng.EngineParams(kp=torch.as_tensor(kp, dtype=torch.float32),
                                kv=torch.as_tensor(kv, dtype=torch.float32), substeps=4)
    ts = teng.default_state(tmodel, 1)
    root = ts.root_pos.clone()
    root[:, 2] = 3.0
    ts = replace(ts, root_pos=root)
    tgt_t = torch.zeros(1, nd)
    t_dof, t_root, t_mj = _errors(
        txval, txval.make_mj_sim(mjcf, tmodel.joint_names, with_plane=False), ts,
        lambda s: teng.step(tmodel, tparams, s, tgt_t)[0], kp, kv, steps, nd)

    jparams = jeng.EngineParams(kp=jnp.asarray(kp, jnp.float32), kv=jnp.asarray(kv, jnp.float32),
                                substeps=4)
    js = jeng.default_state(jmodel, 1)
    js = replace(js, root_pos=js.root_pos.at[:, 2].set(3.0))
    jstep = jax.jit(lambda s: jeng.step(jmodel, jparams, s, jnp.zeros((1, nd)))[0])
    j_dof, j_root, j_mj = _errors(
        jxval, jxval.make_mj_sim(mjcf, jmodel.joint_names, with_plane=False), js, jstep,
        kp, kv, steps, nd)

    for k in t_mj:                                   # the harnesses agree bit for bit
        np.testing.assert_array_equal(t_mj[k], j_mj[k], err_msg=k)
    assert t_mj["root_pos"][2] < 3.0 - 0.5 * 9.81 * (0.01 * steps) ** 2 + 0.01   # it fell
    assert j_dof < DOF_ENVELOPE and j_root < ROOT_ENVELOPE, (j_dof, j_root)
    assert t_dof < DOF_ENVELOPE and t_root < ROOT_ENVELOPE, (t_dof, t_root)
    assert abs(t_dof - j_dof) <= GAP and abs(t_root - j_root) <= GAP
