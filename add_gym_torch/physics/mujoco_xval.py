"""Cross-validation harness: the port's engine against CPU MuJoCo, same scenario.

Counterpart of ``add_gym_tpu/physics/mujoco_xval.py``.  Steps plain CPU
``mujoco`` with the integration semantics the engine stands in for:
implicitfast integrator, Newton solver, 4 iterations, timestep =
ctrl_dt/substeps, per-substep PD torque ``clip(kp(tgt-q) - kv*qd,
+-max_torque)`` into ``qfrc_applied``, with the target clamp + slew limiter
applied once per control step, so single-env trajectories from identical
initial conditions measure how far the engine's ABA + penalty-contact
model is from MuJoCo.  Used by tests/test_torch_mujoco_xval.py.

``mujoco`` is optional (not a dependency of the port): it is imported
inside the functions that step or build a MuJoCo model, so this module
imports where it is absent.
"""

from __future__ import annotations

import os
import tempfile
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np


@dataclass
class MjSim:
    mjm: "mujoco.MjModel"
    mjd: "mujoco.MjData"
    qposadr: np.ndarray   # [nd] qpos index per BFS client dof
    dofadr: np.ndarray    # [nd] qvel/dof index per BFS client dof
    substeps: int
    max_torque: float
    max_target_delta: float
    position_limit_margin: float
    lo: np.ndarray
    hi: np.ndarray
    prev_tgt: np.ndarray  # [nd] slew-limiter state


def _prepared_xml(mjcf_path: str, ctrl_dt: float, substeps: int,
                  with_plane: bool) -> str:
    """The MJCF + a ground plane + the solver options above, written to
    the temporary directory."""
    tree = ET.parse(mjcf_path)
    root = tree.getroot()
    # the prepared copy lives in the temporary directory: point meshdir
    # back at the assets
    comp = root.find("compiler")
    if comp is None:
        comp = ET.SubElement(root, "compiler")
    comp.set(
        "meshdir",
        os.path.join(os.path.dirname(os.path.abspath(mjcf_path)),
                     comp.get("meshdir", ".")),
    )
    opt = root.find("option")
    if opt is None:
        opt = ET.SubElement(root, "option")
    opt.set("timestep", str(ctrl_dt / substeps))
    opt.set("integrator", "implicitfast")
    opt.set("solver", "Newton")
    opt.set("iterations", "4")
    if with_plane:
        wb = root.find("worldbody")
        ET.SubElement(
            wb, "geom",
            {"name": "ground", "type": "plane", "size": "0 0 1",
             "pos": "0 0 0"},
        )
    out = os.path.join(
        tempfile.gettempdir(),
        f"agt_xval_{os.path.basename(mjcf_path)}_{substeps}_{with_plane}.xml",
    )
    tree.write(out)
    return out


def make_mj_sim(mjcf_path: str, joint_names, ctrl_dt: float = 0.01,
                substeps: int = 4, with_plane: bool = True,
                max_torque: float = 200.0, max_target_delta: float = 0.5,
                position_limit_margin: float = 1e-4) -> MjSim:
    import mujoco

    xml = _prepared_xml(mjcf_path, ctrl_dt, substeps, with_plane)
    mjm = mujoco.MjModel.from_xml_path(xml)
    mjd = mujoco.MjData(mjm)
    qposadr, dofadr = [], []
    for name in joint_names:
        j = mjm.joint(name)
        qposadr.append(int(j.qposadr[0]))
        dofadr.append(int(j.dofadr[0]))
    jl = np.stack([np.asarray(mjm.joint(n).range, np.float64)
                   for n in joint_names])
    return MjSim(
        mjm=mjm, mjd=mjd,
        qposadr=np.asarray(qposadr), dofadr=np.asarray(dofadr),
        substeps=substeps, max_torque=max_torque,
        max_target_delta=max_target_delta,
        position_limit_margin=position_limit_margin,
        lo=jl[:, 0] + position_limit_margin,
        hi=jl[:, 1] - position_limit_margin,
        prev_tgt=np.zeros(len(joint_names)),
    )


def set_mj_state(sim: MjSim, root_pos, root_quat, root_vel, root_ang_vel,
                 dof_pos, dof_vel, pd_target=None):
    """Write a BFS-client-order state into MjData.

    Conventions: our root_vel / root_ang_vel are world-frame; MuJoCo's free
    joint qvel is world-frame linear but BODY-LOCAL angular, so the angular
    part is rotated by R^T.
    """
    import mujoco

    d = sim.mjd
    d.qpos[:] = 0
    d.qvel[:] = 0
    d.qpos[0:3] = np.asarray(root_pos, np.float64)
    d.qpos[3:7] = np.asarray(root_quat, np.float64)  # both wxyz
    d.qvel[0:3] = np.asarray(root_vel, np.float64)
    R = _quat_to_mat(np.asarray(root_quat, np.float64))
    d.qvel[3:6] = R.T @ np.asarray(root_ang_vel, np.float64)
    d.qpos[sim.qposadr] = np.asarray(dof_pos, np.float64)
    d.qvel[sim.dofadr] = np.asarray(dof_vel, np.float64)
    sim.prev_tgt = (
        np.asarray(dof_pos, np.float64).copy()
        if pd_target is None else np.asarray(pd_target, np.float64).copy()
    )
    mujoco.mj_forward(sim.mjm, d)


def get_mj_state(sim: MjSim):
    d = sim.mjd
    R = _quat_to_mat(d.qpos[3:7])
    return dict(
        root_pos=d.qpos[0:3].copy(),
        root_quat=d.qpos[3:7].copy(),
        root_vel=d.qvel[0:3].copy(),
        root_ang_vel=R @ d.qvel[3:6],
        dof_pos=d.qpos[sim.qposadr].copy(),
        dof_vel=d.qvel[sim.dofadr].copy(),
    )


def mj_control_step(sim: MjSim, kp, kv, target):
    """One control step with the explicit per-substep PD loop."""
    import mujoco

    d = sim.mjd
    tgt = np.clip(np.asarray(target, np.float64), sim.lo, sim.hi)
    delta = np.clip(tgt - sim.prev_tgt, -sim.max_target_delta,
                    sim.max_target_delta)
    tgt = sim.prev_tgt + delta
    sim.prev_tgt = tgt
    for _ in range(sim.substeps):
        q = d.qpos[sim.qposadr]
        qd = d.qvel[sim.dofadr]
        tau = np.clip(
            np.asarray(kp) * (tgt - q) - np.asarray(kv) * qd,
            -sim.max_torque, sim.max_torque,
        )
        d.qfrc_applied[:] = 0.0
        d.qfrc_applied[sim.dofadr] = tau
        mujoco.mj_step(sim.mjm, d)
    return tgt


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
