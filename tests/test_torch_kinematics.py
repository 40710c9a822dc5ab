"""Port parity: the character model's FK, MJCF export and accessors, the
clip pickle format and the motion library's accessors.

* ``CharModel.forward_kinematics`` against the JAX package's on the mini
  biped and the G1-shaped fixture, batched ``[B, T]``, from random dofs,
  root positions and root rotations made from a numpy seed: positions and
  quaternions within atol 1e-5 (both compose the same f32 quaternion
  products; neither canonicalizes the sign, so the quaternions are
  compared as they are).
* ``export_mjcf`` writes the JAX package's text exactly, and the file
  loads back through both packages' ``load_char_model`` with the same
  structure.
* The accessors (``get_num_joints`` ... ``get_joint_dof_idx``) equal JAX's.
* ``MotionClip.save`` files load through JAX's ``load_motion`` and the
  other way round with exactly equal frames.
* The new ``MotionLib`` accessors equal JAX's, and ``sample_time`` equals
  JAX's ``floor(u * len / dt) * dt`` on the same uniforms (exactly: the
  same f32 operations).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.kinematics.char_model import load_char_model as jax_load_char
from add_gym_tpu.motion.motion_file import MotionClip as JaxClip
from add_gym_tpu.motion.motion_file import load_motion as jax_load_motion
from add_gym_tpu.motion.motion_lib import load_motion_lib as jax_load_lib
from add_gym_torch.kinematics.char_model import load_char_model
from add_gym_torch.motion.motion_file import LoopMode, MotionClip, load_motion
from add_gym_torch.motion.motion_lib import load_motion_lib
from add_gym_torch.physics import testing as fx

torch.set_num_threads(2)

DT = 0.01


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("kin")
    return dict(mini=fx.write_mini_mjcf(str(d)), g1=fx.write_g1_fixture(str(d)),
                clip=fx.write_motion_csv(str(d / "clip.motion"), seed=4, num_frames=61),
                wrap=fx.write_motion_pickle(str(d / "wrap.pkl"), seed=5, loop_mode=1,
                                            num_frames=46))


def _random_pose(char, shape, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (rng.normal(0.0, 0.5, shape + (3,)).astype(np.float32), q.astype(np.float32),
            rng.uniform(-1.5, 1.5, shape + (char.dof_size,)).astype(np.float32))


@pytest.mark.parametrize("which", ["mini", "g1"])
def test_forward_kinematics_matches_jax(files, which):
    jc, tc = jax_load_char(files[which]), load_char_model(files[which])
    rp, rq, dof = _random_pose(tc, (3, 5), seed=11)
    jp, jq = jc.forward_kinematics(jnp.asarray(rp), jnp.asarray(rq),
                                   jc.dof_to_rot(jnp.asarray(dof)))
    tp, tq = tc.forward_kinematics(torch.as_tensor(rp), torch.as_tensor(rq),
                                   tc.dof_to_rot(torch.as_tensor(dof)))
    assert tp.shape == (3, 5, tc.num_bodies, 3) and tq.shape == (3, 5, tc.num_bodies, 4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    # the root passes through; every body quaternion stays unit
    np.testing.assert_array_equal(tp[..., 0, :].numpy(), rp)
    np.testing.assert_allclose(tq.norm(dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("which", ["mini", "g1"])
def test_export_mjcf_matches_jax_and_round_trips(files, which, tmp_path):
    jc, tc = jax_load_char(files[which]), load_char_model(files[which])
    jax_out, torch_out = str(tmp_path / "jax.xml"), str(tmp_path / "torch.xml")
    jc.export_mjcf(jax_out)
    tc.export_mjcf(torch_out)
    with open(jax_out) as a, open(torch_out) as b:
        assert a.read() == b.read()
    for loaded in (load_char_model(torch_out), jax_load_char(torch_out)):
        assert loaded.body_names == tc.body_names
        assert loaded.dof_size == tc.dof_size
        np.testing.assert_array_equal(loaded.parent_indices, tc.parent_indices)
        np.testing.assert_array_equal(loaded.joint_types, tc.joint_types)
        np.testing.assert_allclose(loaded.local_translation, tc.local_translation, atol=1e-4)
        np.testing.assert_allclose(loaded.joint_axes, tc.joint_axes, atol=1e-4)


@pytest.mark.parametrize("which", ["mini", "g1"])
def test_accessors_match_jax(files, which):
    jc, tc = jax_load_char(files[which]), load_char_model(files[which])
    assert tc.get_num_joints() == jc.get_num_joints()
    assert tc.get_dof_size() == jc.get_dof_size()
    assert tc.get_joint_order() == jc.get_joint_order()
    for j, name in enumerate(tc.body_names):
        assert tc.get_body_id(name) == jc.get_body_id(name) == j
        assert tc.get_joint_id(name) == jc.get_joint_id(name)
        assert tc.get_parent_id(j) == jc.get_parent_id(j)
        assert tc.get_joint_dof_dim(j) == jc.get_joint_dof_dim(j)
        assert tc.get_joint_dof_idx(j) == jc.get_joint_dof_idx(j)
    with pytest.raises(KeyError):
        tc.get_body_id("no_such_body")


def test_clip_save_is_read_by_both_packages(files, tmp_path):
    frames = fx.synthetic_motion_frames(seed=6, num_frames=31)
    port_file, jax_file = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    MotionClip(loop_mode=LoopMode.WRAP, fps=60, frames=frames).save(port_file)
    JaxClip(loop_mode=1, fps=60, frames=frames).save(jax_file)
    for path in (port_file, jax_file):
        for clip in (load_motion(path), jax_load_motion(path)):
            assert int(clip.loop_mode) == 1 and clip.fps == 60
            np.testing.assert_array_equal(clip.frames, frames)
    # and a CSV clip the port reads equals what JAX reads, frame for frame
    np.testing.assert_array_equal(load_motion(files["clip"]).frames,
                                  jax_load_motion(files["clip"]).frames)


def test_motion_lib_accessors_and_sample_time(files):
    order = fx.MOTION_JOINT_ORDER
    tchar, jchar = load_char_model(files["g1"]), jax_load_char(files["g1"])
    for kind in ("clip", "wrap"):
        jlib = jax_load_lib(files[kind], order, jchar, dt=DT)
        tlib = load_motion_lib(files[kind], order, tchar, dt=DT)
        assert tlib.get_num_motions() == jlib.get_num_motions() == 1
        assert tlib.get_total_length() == pytest.approx(jlib.get_total_length(), abs=0)
        ids = np.zeros(7, np.int64)
        np.testing.assert_array_equal(tlib.get_motion_length(torch.as_tensor(ids)).numpy(),
                                      np.asarray(jlib.get_motion_length(jnp.asarray(ids))))
        np.testing.assert_array_equal(tlib.get_motion_loop_mode(torch.as_tensor(ids)).numpy(),
                                      np.asarray(jlib.get_motion_loop_mode(jnp.asarray(ids))))

        g = torch.Generator().manual_seed(3)
        u = torch.rand(ids.shape, generator=g).numpy()
        g.manual_seed(3)
        t = tlib.sample_time(torch.as_tensor(ids), generator=g).numpy()
        # JAX's sample_time on the same uniforms
        want = jnp.floor(jnp.asarray(u) * jlib.lengths[jnp.asarray(ids)] / jlib.dt) * jlib.dt
        np.testing.assert_array_equal(t, np.asarray(want))
        assert (t >= 0).all() and (t < tlib.get_total_length()).all()
        np.testing.assert_allclose(np.round(t / DT) * DT, t, atol=1e-6)
