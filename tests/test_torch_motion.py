"""Port parity: motion clips, the motion library and the sampler.

Both packages load the same synthetic clips: a ``.motion`` CSV (CLAMP) and
a pickle clip in WRAP mode.  The precomputed tables run through each
package's f32 rotation library (slerp, twist angles, finite differences),
so they agree to atol = 1e-4 (velocities are differences scaled by 30 fps)
and 2e-6 elsewhere.  The lookup itself is integer logic on top of the
tables: on identical tables it must agree exactly, including WRAP times
whose fractional frame is above 0.75, where the ``floor(t * dt_inv + 0.25)``
rule of the JAX package picks the next frame.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.kinematics.char_model import load_char_model as jax_load_char
from add_gym_tpu.learning import sampler as jsampler
from add_gym_tpu.motion.motion_lib import load_motion_lib as jax_load_lib
from add_gym_torch.kinematics.char_model import load_char_model
from add_gym_torch.learning import sampler as tsampler
from add_gym_torch.motion.motion_file import load_motion, parse_motion_csv
from add_gym_torch.motion.motion_lib import MotionLib, load_motion_lib
from add_gym_torch.physics import testing as fx

torch.set_num_threads(2)

DT = 0.01


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("motion")
    mjcf = fx.write_g1_fixture(str(d))
    csv = fx.write_motion_csv(str(d / "clamp.motion"), seed=1, num_frames=61)
    wrap = fx.write_motion_pickle(str(d / "wrap.pkl"), seed=2, loop_mode=1, num_frames=46)
    return mjcf, {"clamp": csv, "wrap": wrap}


@pytest.fixture(scope="module", params=["clamp", "wrap"])
def libs(request, clips):
    mjcf, paths = clips
    order = fx.MOTION_JOINT_ORDER
    jlib = jax_load_lib(paths[request.param], order, jax_load_char(mjcf), dt=DT)
    tlib = load_motion_lib(paths[request.param], order, load_char_model(mjcf), dt=DT)
    return request.param, jlib, tlib


def test_csv_parse_and_clip_length(clips):
    _, paths = clips
    frames = parse_motion_csv(paths["clamp"])
    assert frames.shape == (61, 36)
    clip = load_motion(paths["clamp"])
    assert clip.get_length() == pytest.approx(60 / 30)
    assert int(load_motion(paths["wrap"]).loop_mode) == 1


def test_tables_match(libs):
    kind, jlib, tlib = libs
    np.testing.assert_array_equal(tlib.meta_all.numpy(), np.asarray(jlib.meta_all))
    np.testing.assert_array_equal(tlib.lengths.numpy(), np.asarray(jlib.lengths))
    np.testing.assert_array_equal(tlib.weights.numpy(), np.asarray(jlib.weights))
    a, b = np.asarray(jlib.step_all), tlib.step_all.numpy()
    assert a.shape == b.shape
    D = (a.shape[1] - 13) // 2
    vel_cols = np.r_[7:13, 13 + D:13 + 2 * D]
    pos_cols = np.setdiff1d(np.arange(a.shape[1]), vel_cols)
    np.testing.assert_allclose(b[:, pos_cols], a[:, pos_cols], atol=2e-6)
    np.testing.assert_allclose(b[:, vel_cols], a[:, vel_cols], atol=1e-4)


def _query_times(length, rng, n=200):
    t = rng.uniform(-0.5, 3.5 * length, n)
    # grid points, and fractional frames above 0.75 (t*100 = k + 0.8)
    t[:40] = np.round(t[:40] / DT) * DT
    t[40:80] = (np.floor(t[40:80] / DT) + 0.8) * DT
    return t.astype(np.float32)


def test_lookup_is_exact_on_identical_tables(libs):
    kind, jlib, tlib = libs
    # the port's lookup over the JAX tables
    same = dataclasses.replace(
        tlib,
        step_all=torch.as_tensor(np.array(jlib.step_all)),
        meta_all=torch.as_tensor(np.array(jlib.meta_all)),
    )
    rng = np.random.default_rng(0)
    t = _query_times(float(jlib.lengths[0]), rng)
    ids = np.zeros(t.shape, np.int32)
    want = np.asarray(jlib.get_motion_rows(jnp.asarray(ids), jnp.asarray(t)))
    got = same.get_motion_rows(torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), want)
    # 2-D ids/times as the env's window gathers use them
    want2 = jlib.get_motion_step(jnp.asarray(ids.reshape(20, 10)), jnp.asarray(t.reshape(20, 10)))
    got2 = same.get_motion_step(torch.as_tensor(ids.reshape(20, 10), dtype=torch.int64),
                                torch.as_tensor(t.reshape(20, 10)))
    for a, b in zip(want2, got2):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if kind == "wrap":
        # loops accumulate the root displacement: later loops sit further on
        rows = got.numpy()
        later = t > 2.0 * float(jlib.lengths[0])
        assert np.abs(rows[later, 0]).max() > np.abs(rows[~later, 0]).max()


def test_lookup_matches_on_own_tables(libs):
    kind, jlib, tlib = libs
    rng = np.random.default_rng(1)
    t = _query_times(float(jlib.lengths[0]), rng)
    ids = np.zeros(t.shape, np.int32)
    want = np.asarray(jlib.get_motion_rows(jnp.asarray(ids), jnp.asarray(t)))
    got = tlib.get_motion_rows(torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_split_rows_and_phase(libs):
    kind, jlib, tlib = libs
    t = np.linspace(0.0, 2.5 * float(jlib.lengths[0]), 33).astype(np.float32)
    ids = np.zeros(t.shape, np.int64)
    want = jlib.calc_motion_phase(jnp.asarray(ids, jnp.int32), jnp.asarray(t))
    got = tlib.calc_motion_phase(torch.as_tensor(ids), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    row = tlib.step_all[:5]
    parts = MotionLib.split_rows(row)
    assert [p.shape[-1] for p in parts] == [3, 4, 3, 3, 29, 29]
    assert torch.equal(torch.cat(parts, dim=-1), row)


def test_sampler_probs_and_update():
    rng = np.random.default_rng(3)
    errors = rng.uniform(0.5, 2.0, (3, 20)).astype(np.float32)
    ids = rng.integers(0, 3, 50)
    js = jsampler.SamplerState(errors=jnp.asarray(errors))
    ts = tsampler.SamplerState(errors=torch.as_tensor(errors))
    np.testing.assert_allclose(
        tsampler.segment_probs(ts, torch.as_tensor(ids)).numpy(),
        np.asarray(jsampler.segment_probs(js, jnp.asarray(ids))), atol=1e-7,
    )
    seg_sizes = np.array([0.1, 0.2, 0.15], np.float32)
    steps = rng.uniform(0.0, 3.0, 50).astype(np.float32)
    err = rng.uniform(0.0, 1.0, 50).astype(np.float32)
    want = jsampler.update_errors(js, jnp.asarray(seg_sizes), jnp.asarray(ids),
                                  jnp.asarray(steps), jnp.asarray(err))
    got = tsampler.update_errors(ts, torch.as_tensor(seg_sizes), torch.as_tensor(ids),
                                 torch.as_tensor(steps), torch.as_tensor(err))
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors), atol=1e-6)


def test_sampled_start_times_are_on_the_grid(libs):
    kind, jlib, tlib = libs
    g = torch.Generator().manual_seed(0)
    state = tsampler.init_sampler(1, 20)
    ids = tlib.sample_motions(500, g)
    assert (ids == 0).all()
    t = tsampler.sample_start_time(state, ids, tlib.lengths / 20, DT, 0.02, generator=g)
    assert (t >= 0.02).all() and (t < tlib.lengths[0]).all()
    frames = t / DT
    assert torch.allclose(frames, torch.round(frames), atol=1e-3)
