"""The port's tools: the viewer, the probe, the clip converter, the
publisher and the ``Robot`` facade, each held to the JAX package's.

* ``view.playback_poses`` against JAX's on the G1-shaped fixture and a
  synthetic clip: body positions and rotations within atol 1e-5 (FK of
  motion-table rows that agree to 2e-6); ``view.main([... "device=cpu"])``
  writes the JAX viewer's npz keys and a mesh GIF.
* ``probe.main`` prints the model summary and the DOF mapping and hands
  its namespace to IPython, or to ``code.interact`` where IPython does not
  import (both patched).
* ``convert_motion`` round trips a file and a directory, with the fps and
  loop-mode overrides; the pickles load through the JAX package too.
* ``publish.export`` of a one-iteration CPU checkpoint: ``model.pt``
  reloads bit for bit equal to the checkpoint's parameters, the optimizer
  state is gone, ``metadata.json``'s dims equal the JAX env's for the same
  config, and the model card has hub front matter; ``push_to_hf`` keeps the
  JAX publisher's contract against a mock hub (nothing is uploaded).
* ``Robot`` against JAX's ``Robot``: lookups, gains and action bounds
  equal, ``base_init_pos`` within atol 1e-6, the same default state, the
  same ``ground_contact_flags``; the default state keeps standing on its
  feet under stiff gains.
"""

import builtins
import code
import json
import os
import pickle
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.builder import build_env as jax_build_env
from add_gym_tpu.cli.view import playback_poses as jax_playback_poses
from add_gym_tpu.kinematics.char_model import load_char_model as jax_load_char
from add_gym_tpu.motion.motion_file import load_motion as jax_load_motion
from add_gym_tpu.motion.motion_lib import load_motion_lib as jax_load_lib
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_tpu.robot import Robot as JaxRobot
from add_gym_tpu.utils.config import load_config as jax_load_config
from add_gym_torch.cli import convert_motion, probe, publish, view
from add_gym_torch.cli.train import main as cli_main
from add_gym_torch.kinematics.char_model import load_char_model
from add_gym_torch.motion.motion_file import LoopMode, load_motion
from add_gym_torch.motion.motion_lib import load_motion_lib
from add_gym_torch.physics import engine as eng
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.model import build_physics_model
from add_gym_torch.robot import Robot

torch.set_num_threads(2)

FPS = 30.0
SMALL_NET = "fc_2layers_64units"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    return dict(mesh=fx.write_mesh_fixture(str(d)), g1=fx.write_g1_fixture(str(d)),
                clip=fx.write_motion_csv(str(d / "clip.motion"), seed=7, num_frames=40))


# ------------------------------------------------------------------- view


def test_playback_poses_match_jax(files):
    order = fx.MOTION_JOINT_ORDER
    tc, jc = load_char_model(files["g1"]), jax_load_char(files["g1"])
    tlib = load_motion_lib(files["clip"], order, tc, dt=1.0 / FPS)
    jlib = jax_load_lib(files["clip"], order, jc, dt=1.0 / FPS)
    t_times, t_pos, t_rot = view.playback_poses(tc, tlib, fps=FPS, max_seconds=1.0)
    j_times, j_pos, j_rot = jax_playback_poses(jc, jlib, fps=FPS, max_seconds=1.0)
    np.testing.assert_array_equal(t_times, j_times)
    assert t_pos.shape == (30, 30, 3) and t_rot.shape == (30, 30, 4)
    np.testing.assert_allclose(t_pos, np.asarray(j_pos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_rot, np.asarray(j_rot), rtol=0, atol=1e-5)


def test_view_main_on_the_cpu(files, tmp_path):
    out, video = tmp_path / "play.npz", tmp_path / "play.gif"
    view.main([f"robot.asset_path={files['mesh']}", f"task.motion_file={files['clip']}",
               f"out={out}", f"video={video}", "max_seconds=0.5", "device=cpu"])
    d = np.load(out)
    assert set(d.files) == {"times", "body_pos", "body_rot", "body_names", "parents"}
    assert d["body_pos"].shape == (15, 30, 3) and np.isfinite(d["body_pos"]).all()
    assert list(d["body_names"]) == load_char_model(files["mesh"]).body_names
    assert os.path.getsize(video) > 0


# ------------------------------------------------------------------ probe


@pytest.mark.parametrize("shell", ["ipython", "code"])
def test_probe_prints_and_opens_a_shell(files, monkeypatch, capsys, shell):
    seen = {}
    if shell == "ipython":
        import IPython

        monkeypatch.setattr(IPython, "start_ipython",
                            lambda argv, user_ns: seen.update(user_ns))
    else:
        monkeypatch.setitem(sys.modules, "IPython", None)     # import raises ImportError
        monkeypatch.setattr(code, "interact", lambda local: seen.update(local))
    probe.main([f"robot.asset_path={files['g1']}", f"task.motion_file={files['clip']}",
                "frame_time=0.5", "device=cpu"])
    out = capsys.readouterr().out
    assert "bodies: 30  dofs: 29" in out
    assert out.count("<- motion col") == 29 and "frame at t=0.50s" in out
    assert seen["body_pos"].shape == (1, 30, 3) and seen["model"].nd == 29
    np.testing.assert_allclose(seen["body_pos"][0, 0].numpy(), seen["rp"][0].numpy())


# --------------------------------------------------------- convert_motion


def test_convert_motion_round_trip_file_and_directory(files, tmp_path):
    src = files["clip"]
    dst = str(tmp_path / "clip.pkl")
    convert_motion.main([src, dst])
    a, b = load_motion(src), load_motion(dst)
    np.testing.assert_array_equal(a.frames, b.frames)
    assert b.fps == a.fps and b.loop_mode == a.loop_mode == LoopMode.CLAMP
    np.testing.assert_array_equal(jax_load_motion(dst).frames, a.frames)

    dst2 = str(tmp_path / "clip_wrap.pkl")
    convert_motion.main([dst, dst2, "--fps", "60", "--loop", "wrap"])
    c = load_motion(dst2)
    assert c.loop_mode == LoopMode.WRAP and c.fps == 60.0
    with open(dst2, "rb") as f:
        assert set(pickle.load(f)) == {"loop_mode", "fps", "frames"}

    src_dir, out_dir = tmp_path / "clips", tmp_path / "out"
    src_dir.mkdir()
    for seed in (1, 2):
        fx.write_motion_csv(str(src_dir / f"c{seed}.motion"), seed=seed, num_frames=20)
    (src_dir / "notes.txt").write_text("not a clip")
    convert_motion.main([str(src_dir), str(out_dir), "--loop", "wrap"])
    assert sorted(os.listdir(out_dir)) == ["c1.pkl", "c2.pkl"]
    for seed in (1, 2):
        clip = load_motion(str(out_dir / f"c{seed}.pkl"))
        assert clip.loop_mode == LoopMode.WRAP
        np.testing.assert_array_equal(clip.frames, load_motion(str(src_dir / f"c{seed}.motion")).frames)


# ---------------------------------------------------------------- publish


def _train_args(files, log_dir):
    return ["train", "device=cpu", f"robot.asset_path={files['g1']}",
            f"task.motion_file={files['clip']}", "engine.num_envs=4",
            "agent.steps_per_iter=4", "agent.batch_size=2", "agent.update_epochs=1",
            f"agent.actor_net={SMALL_NET}", f"agent.critic_net={SMALL_NET}",
            f"agent.disc_net={SMALL_NET}", "test_episodes=0", "iters_per_output=1",
            f"log_dir={log_dir}", "experiment_name=pub", "max_iters=1"]


def test_publish_export(files, tmp_path):
    cli_main(_train_args(files, tmp_path))
    ckpt = tmp_path / "pub" / "checkpoint"
    out = tmp_path / "artifact"
    publish.main([str(ckpt), str(out), "--name", "g1-test"])
    assert sorted(os.listdir(out)) == ["README.md", "config.json", "metadata.json",
                                       "model.pt", "normalizers.pt"]

    saved = torch.load(ckpt / "train_state.pt", weights_only=True)["train_state"]
    params = torch.load(out / "model.pt", weights_only=True)
    assert params.keys() == saved["params"].keys()
    for k, v in saved["params"].items():
        assert params[k].dtype == v.dtype and torch.equal(params[k], v), k
    norms = torch.load(out / "normalizers.pt", weights_only=True)
    assert set(norms) == {"obs_norm", "disc_norm"}
    for group in norms:
        for k, v in saved[group].items():
            assert torch.equal(norms[group][k], v), (group, k)
    assert not any(k.startswith("opt") for k in params)

    meta = json.loads((out / "metadata.json").read_text())
    jcfg = jax_load_config("train")
    jcfg["robot"]["asset_path"], jcfg["task"]["motion_file"] = files["g1"], files["clip"]
    jcfg["engine"]["num_envs"] = 8
    jenv = jax_build_env(jcfg)
    assert (meta["obs_dim"], meta["disc_obs_dim"], meta["action_dim"]) == (
        jenv.obs_dim(), jenv.disc_obs_dim(), jenv.num_dofs)
    assert meta["name"] == "g1-test" and meta["iter"] == 1 and meta["sample_count"] == 16
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["engine"]["num_envs"] == 4          # the training config, as it was

    head = (out / "README.md").read_text().split("---")[1]
    assert "license:" in head and "library_name: pytorch" in head
    assert "reinforcement-learning" in head


class _MockHfApi:
    calls = []

    def create_repo(self, repo_id, repo_type=None, private=False, exist_ok=False):
        _MockHfApi.calls.append(("create_repo", repo_id, repo_type, private, exist_ok))

    def upload_folder(self, repo_id, folder_path, repo_type=None, commit_message=None):
        _MockHfApi.calls.append(("upload_folder", repo_id, folder_path, repo_type,
                                 commit_message))


def test_push_to_hf_contract(tmp_path, monkeypatch):
    import huggingface_hub

    monkeypatch.setattr(huggingface_hub, "HfApi", _MockHfApi)
    _MockHfApi.calls = []
    (tmp_path / "model.pt").write_bytes(b"\x00")
    (tmp_path / "README.md").write_text("---\nlicense: mit\n---\n# m\n")
    (tmp_path / "metadata.json").write_text(json.dumps({"iter": 1234}))

    url = publish.push_to_hf(str(tmp_path), "org/my-g1", private=True)

    assert url == "https://huggingface.co/org/my-g1"
    assert [c[0] for c in _MockHfApi.calls] == ["create_repo", "upload_folder"]
    assert _MockHfApi.calls[0][1:] == ("org/my-g1", "model", True, True)
    up = _MockHfApi.calls[1]
    assert up[1] == "org/my-g1" and up[2] == str(tmp_path) and "iter 1234" in up[4]


def test_publish_imports_the_hub_lazily(monkeypatch):
    """Without huggingface_hub only the hub push fails."""
    real_import = builtins.__import__

    def no_hub(name, *a, **kw):
        if name.startswith("huggingface_hub"):
            raise ImportError("no huggingface_hub")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_hub)
    with pytest.raises(ImportError, match="huggingface_hub"):
        publish.push_to_hf("unused", "org/repo")


# ------------------------------------------------------------------ robot


def test_robot_matches_jax(files):
    trobot = Robot(build_physics_model(files["g1"]))
    jrobot = JaxRobot(jax_build_model(files["g1"]))
    assert trobot.link_lookup == jrobot.link_lookup
    assert trobot.joint_lookup == jrobot.joint_lookup
    assert len(trobot.links_by_tag("feet")) == 4 and len(trobot.joints_by_tag("arm")) == 14
    for k in ("kp", "kv", "default_dof_pos", "base_init_quat", "action_low", "action_high"):
        np.testing.assert_array_equal(getattr(trobot, k), getattr(jrobot, k), err_msg=k)
    np.testing.assert_allclose(trobot.base_init_pos, jrobot.base_init_pos, rtol=0, atol=1e-6)

    ts, js = trobot.default_sim_state(3), jrobot.default_sim_state(3)
    for f in fx.STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    pos, rot = trobot.body_poses(ts)
    assert pos.shape == (3, 30, 3) and rot.shape == (3, 30, 3, 3)
    np.testing.assert_allclose(pos[:, 0, 2].numpy(), trobot.base_init_pos[2], atol=1e-6)

    contact = np.random.default_rng(2).choice([0.0, 0.0, 0.0, 5.0], size=(16, 30))
    want = np.asarray(jrobot.ground_contact_flags(jnp.asarray(contact), "feet"))
    got = trobot.ground_contact_flags(torch.as_tensor(contact), "feet")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(trobot.ground_contact_flags(contact, [1, 2]),
                                  np.asarray(jrobot.ground_contact_flags(contact, [1, 2])))


def test_robot_default_state_stands(files):
    robot = Robot(build_physics_model(files["g1"]))
    params = eng.EngineParams(kp=torch.as_tensor(robot.kp * 3),
                              kv=torch.as_tensor(robot.kv * np.sqrt(3)))
    s = robot.default_sim_state(2)
    target = torch.as_tensor(robot.default_dof_pos)[None].expand(2, -1)
    for _ in range(40):
        s, contact = eng.step(robot.model, params, s, target)
    assert bool(robot.ground_contact_flags(contact, "feet").all())
    not_feet = [i for i in range(robot.model.nb) if i not in robot.links_by_tag("feet")]
    assert not bool((contact[:, not_feet] > 0).any())
    assert float(s.root_pos[0, 2]) > 0.7
