"""The port's video path: ``ADDAgent.eval_rollout_states``,
``Trainer.record_video``, ``video_interval`` and the mesh renderer.

* ``eval_rollout_states`` against the JAX package's on the mini biped,
  from the same state with the reset draws JAX takes from each step's key,
  with env 0's episode ending mid-rollout (a reset shows as a jump in both):
  root position, root rotation and dofs within rtol = atol = 1e-4 (the
  tolerance of tests/test_torch_runner.py for what derives from a physics
  step), motion ids exactly, motion times within 1e-6.
* ``record_video`` on the mesh fixture (``write_mesh_fixture``):
  ``body_pos``/``body_rot`` equal the FK of the recorded states (the same
  function on the same device: exactly), the ghost the FK of the reference
  motion at the recorded ids and times, and the GIF is written.  The JAX
  package's ``record_video``, handed the same recorded states in place of
  its rollout, writes the same npz keys, shapes and dtypes, and the same
  poses within atol 1e-5 (the FK tolerance).
* ``render_frames`` of the port equals the JAX package's pixel for pixel
  on identical numpy inputs.
* The physics model built from the mesh fixture equals the plain
  fixture's, array for array (its mesh geoms do not collide).
* A rank-1 ``Trainer`` rolls its envs forward and writes nothing.
* ``video_interval=1`` through ``cli.train`` writes one
  ``rollout_<iter>.gif.npz`` per output iteration.
"""

import dataclasses
import functools
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_agent as jax_build_agent
from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.learning.runner import Trainer as JaxTrainer
from add_gym_tpu.render.mesh import RobotMeshModel as JaxMeshModel
from add_gym_tpu.render.mesh import render_frames as jax_render_frames
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.builder import build_agent, build_env
from add_gym_torch.cli.train import main as cli_main
from add_gym_torch.kinematics.char_model import load_char_model
from add_gym_torch.learning.convert import from_jax
from add_gym_torch.learning.runner import Trainer
from add_gym_torch.parallel.mesh import Dist
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.model import build_physics_model
from add_gym_torch.render.mesh import RobotMeshModel, render_frames
from add_gym_torch.utils.config import load_config

torch.set_num_threads(2)

N, T = 4, 4
NPZ_KEYS = {"body_pos", "body_rot", "ghost_body_pos", "ghost_body_rot", "body_names", "parents"}
MINI_JOINTS = ["left_leg_joint", "right_leg_joint"]
SMALL_NET = "fc_2layers_64units"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("video"))
    return dict(mesh=fx.write_mesh_fixture(d), plain=fx.write_g1_fixture(d),
                clip=fx.write_motion_csv(os.path.join(d, "clip.motion"), seed=5, num_frames=120))


def _cfg(load, files, log_dir, **top):
    cfg = load("train")
    cfg["robot"]["asset_path"], cfg["task"]["motion_file"] = files["mesh"], files["clip"]
    cfg["engine"]["num_envs"] = N
    cfg["agent"].update(steps_per_iter=T, update_epochs=1, batch_size=2, mixed_precision=False,
                        actor_net=SMALL_NET, critic_net=SMALL_NET, disc_net=SMALL_NET)
    cfg.update(test_episodes=0, log_dir=str(log_dir), experiment_name="video")
    cfg.update(top)
    return cfg


def _mini_cfg(load, mjcf, clip):
    cfg = load("train")
    cfg["robot"]["asset_path"] = mjcf
    cfg["robot"]["joints"] = [{"match": ".*leg_joint", "tags": ["hip"]}]
    cfg["task"]["motion_file"] = clip
    cfg["task"]["motion_joint_order"] = MINI_JOINTS
    cfg["task"]["contact_bodies"] = ["left_leg_link", "right_leg_link"]
    cfg["engine"]["num_envs"] = 8
    cfg["agent"]["mixed_precision"] = False
    for k in ("actor_net", "critic_net", "disc_net"):
        cfg["agent"][k] = SMALL_NET
    return cfg


# ------------------------------------------------------- eval_rollout_states


def test_eval_rollout_states_matches_jax(tmp_path):
    n, steps = 8, 8
    mjcf = fx.write_mini_mjcf(str(tmp_path))
    clip = fx.write_motion_csv(str(tmp_path / "mini.motion"), seed=3, num_frames=90,
                               joint_order=MINI_JOINTS, height=0.65)
    jcfg = _mini_cfg(jax_load_config, mjcf, clip)
    jenv = jax_build_env(jcfg)
    jagent = jax_build_agent(jcfg, jenv)
    jts = jagent.init_train_state(jax.random.PRNGKey(7))
    tcfg = _mini_cfg(load_config, mjcf, clip)
    tenv = build_env(tcfg, device="cpu")
    tagent = build_agent(tcfg, tenv)
    tts = from_jax(tagent, jts)

    key0 = jax.random.PRNGKey(0)
    jes = jenv.reset_where(key0, jenv.init_state(n), jnp.ones(n, bool), jts.sampler)
    k1, k2, _ = jax.random.split(key0, 3)
    r_ids = jenv.motion.sample_motions(k1, n)
    r_times = jenv._sample_times(k2, r_ids, jts.sampler)
    tes = tenv.reset_where(tenv.init_state(n), torch.ones(n, dtype=torch.bool), tts.sampler,
                           draws=(np.asarray(r_ids), np.asarray(r_times)))
    # env 0 reaches the end of its clip at the fourth step, env 2 the
    # episode cap at the first
    ep_time = np.zeros(n, np.float32)
    clip_len = float(tenv.motion.lengths[tes.motion_ids[0]])
    ep_time[0] = clip_len - float(tes.motion_offsets[0]) - 0.035
    ep_time[2] = jcfg["task"]["max_episode_length"] - 0.005
    jes = dataclasses.replace(jes, time=jnp.asarray(ep_time))
    tes = dataclasses.replace(tes, time=torch.as_tensor(ep_time))
    jobs, tobs = jenv.compute_obs(jes), tenv.compute_obs(tes)

    key = jax.random.PRNGKey(4)
    ids, times = [], []
    k = key
    for _ in range(steps):              # the reset draws of each step's key
        k, _, k_reset = jax.random.split(k, 3)
        ka, kb, _ = jax.random.split(k_reset, 3)
        ids.append(np.asarray(jenv.motion.sample_motions(ka, n)))
        times.append(np.asarray(jenv._sample_times(kb, jnp.asarray(ids[-1]), jts.sampler)))
    jes2, jobs2, jst = jagent.eval_rollout_states(jts, jes, jobs, steps, key)
    tes2, tobs2, tst = tagent.eval_rollout_states(
        tts, tes, tobs, steps, draws=(None, None, np.stack(ids), np.stack(times)))

    assert set(tst) == set(jst)
    for k in ("root_pos", "root_quat", "dof_pos"):
        assert tst[k].shape == jst[k].shape
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(tst["motion_id"].numpy(), np.asarray(jst["motion_id"]))
    np.testing.assert_allclose(tst["motion_time"].numpy(), np.asarray(jst["motion_time"]),
                               rtol=0, atol=1e-6)
    # env 0 resets once: its motion time jumps once, else advances by dt
    jumps = np.abs(np.diff(tst["motion_time"].numpy()) - 0.01) > 1e-3
    assert jumps.sum() == 1, tst["motion_time"]
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=1e-4, atol=1e-4)
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(tes2.sim, f).numpy(), np.asarray(getattr(jes2.sim, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


# -------------------------------------------------------------- record_video


def test_record_video_on_mesh_fixture(files, tmp_path, monkeypatch):
    t = Trainer(_cfg(load_config, files, tmp_path, device="cpu"))
    seen = {}
    real = t.agent.eval_rollout_states

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen["states"] = out[2]
        return out

    monkeypatch.setattr(t.agent, "eval_rollout_states", spy)
    es0 = t.es
    path = str(tmp_path / "rollout.gif")
    info = t.record_video(path, seconds=0.1)
    frames = 10
    assert info["frames"] == frames and info["rollout_ms"] > 0
    assert info["render_ms_per_frame"] is not None
    assert os.path.getsize(path) > 0                 # the mesh GIF
    assert not torch.equal(t.es.time, es0.time)      # the trainer's envs moved on

    d = np.load(path + ".npz")
    assert set(d.files) == NPZ_KEYS
    nb = 30
    for k, shape in (("body_pos", (frames, nb, 3)), ("body_rot", (frames, nb, 4)),
                     ("ghost_body_pos", (frames, nb, 3)), ("ghost_body_rot", (frames, nb, 4))):
        assert d[k].shape == shape and np.isfinite(d[k]).all(), k
    char = load_char_model(files["mesh"])
    assert list(d["body_names"]) == char.body_names
    np.testing.assert_array_equal(d["parents"], char.parent_indices)

    st = seen["states"]
    bp, br = char.forward_kinematics(st["root_pos"], st["root_quat"],
                                     char.dof_to_rot(st["dof_pos"]))
    np.testing.assert_array_equal(d["body_pos"], bp.numpy())
    np.testing.assert_array_equal(d["body_rot"], br.numpy())
    rp, rq, _, _, dp, _ = t.env.motion.get_motion_step(st["motion_id"], st["motion_time"])
    gp, gr = char.forward_kinematics(rp, rq, char.dof_to_rot(dp))
    np.testing.assert_array_equal(d["ghost_body_pos"], gp.numpy())
    np.testing.assert_array_equal(d["ghost_body_rot"], gr.numpy())
    t.close()

    # JAX's record_video on the same recorded states (its rollout replaced
    # by them) writes the same keys, shapes and dtypes, and the same poses
    # within the FK tolerance of tests/test_torch_kinematics.py
    jt = object.__new__(JaxTrainer)
    jt.env = jax_build_env(_cfg(jax_load_config, files, tmp_path))
    jt.mesh, jt.ts, jt.es, jt.obs = None, None, None, None
    jt._next_key = lambda: jax.random.PRNGKey(0)
    jax_states = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    jt.agent = types.SimpleNamespace(
        eval_rollout_states=lambda ts, es, obs, steps, key: (es, obs, jax_states))
    monkeypatch.setattr("add_gym_tpu.cli.view.render_video", lambda *a, **kw: None)
    jpath = str(tmp_path / "jax_rollout.gif")
    jt.record_video(jpath, seconds=0.1)
    jd = np.load(jpath + ".npz")
    assert set(jd.files) == set(d.files)
    for k in jd.files:
        assert jd[k].shape == d[k].shape and jd[k].dtype.kind == d[k].dtype.kind, k
        if jd[k].dtype.kind == "f":
            np.testing.assert_allclose(d[k], jd[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(d[k], jd[k], err_msg=k)


def test_render_frames_match_jax_pixel_for_pixel(files):
    char = load_char_model(files["mesh"])
    rng = np.random.default_rng(9)
    F = 2
    rp = np.tile(np.asarray([0.0, 0.0, 0.8], np.float32), (F, 1))
    rq = np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (F, 1))
    dof = rng.uniform(-0.4, 0.4, (F, char.dof_size)).astype(np.float32)
    bp, br = char.forward_kinematics(torch.as_tensor(rp), torch.as_tensor(rq),
                                     char.dof_to_rot(torch.as_tensor(dof)))
    bp, br = bp.numpy(), br.numpy()
    ghost = bp + np.asarray([0.4, 0.0, 0.0], np.float32)
    mine = render_frames(RobotMeshModel(files["mesh"], char.body_names), bp, br, ghost, br,
                         size=(160, 120))
    theirs = jax_render_frames(JaxMeshModel(files["mesh"], char.body_names), bp, br, ghost, br,
                               size=(160, 120))
    assert len(mine) == len(theirs) == F
    for a, b in zip(mine, theirs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == (120, 160, 3)
        assert (a != a[0, 0]).any()                  # something was drawn
        np.testing.assert_array_equal(a, b)


def test_mesh_fixture_physics_model_equals_plain_fixture(files):
    a, b = build_physics_model(files["mesh"]), build_physics_model(files["plain"])
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    assert len(RobotMeshModel(files["mesh"], list(a.body_names)).meshes) == a.nb


def test_rank_one_rolls_forward_and_writes_nothing(files, tmp_path):
    dist = Dist(rank=1, world_size=2, device=torch.device("cpu"))
    t = Trainer(_cfg(load_config, files, tmp_path, device="cpu"), dist=dist)
    es0 = t.es
    path = str(tmp_path / "rank1.gif")
    assert t.record_video(path, seconds=0.05) is None
    assert not os.path.exists(path) and not os.path.exists(path + ".npz")
    assert t.es.time.shape == (N // 2,) and not torch.equal(t.es.time, es0.time)
    t.close()


def test_video_interval_through_cli_train(files, tmp_path, monkeypatch):
    monkeypatch.setattr(Trainer, "record_video",
                        functools.partialmethod(Trainer.record_video, seconds=0.05))
    args = ["train", "device=cpu", f"robot.asset_path={files['mesh']}",
            f"task.motion_file={files['clip']}", f"engine.num_envs={N}",
            f"agent.steps_per_iter={T}", "agent.batch_size=2", "agent.update_epochs=1",
            f"agent.actor_net={SMALL_NET}", f"agent.critic_net={SMALL_NET}",
            f"agent.disc_net={SMALL_NET}", "test_episodes=0", "iters_per_output=1",
            f"log_dir={tmp_path}", "experiment_name=cli", "video_interval=1", "max_iters=2"]
    assert cli_main(args) is None
    exp = tmp_path / "cli"
    assert sorted(f for f in os.listdir(exp) if f.endswith(".npz")) == [
        "rollout_0000000.gif.npz", "rollout_0000001.gif.npz"]
    d = np.load(exp / "rollout_0000001.gif.npz")
    assert d["body_pos"].shape == (5, 30, 3)
