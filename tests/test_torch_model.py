"""Port parity: host-side model build (MJCF parse, physics model, control-
step constants, PD gains, character model conversions).

Both packages parse the same MJCF files: the mini biped and the G1-shaped
fixture.  Every array must be equal (exactly: the same numpy code runs in
both), except the character-model conversions on tensors, which run in
f32 through each package's rotation library (atol = 1e-6).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from add_gym_tpu.kinematics.char_model import load_char_model as jax_load_char
from add_gym_tpu.physics.fused_step import FusedModelConstants as JaxFMC
from add_gym_tpu.physics.model import build_physics_model as jax_build_model
from add_gym_tpu.robot import build_pd_gains as jax_pd_gains
from add_gym_torch.kinematics.char_model import load_char_model
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.fused_step import FusedModelConstants
from add_gym_torch.physics.model import build_physics_model
from add_gym_torch.robot import build_pd_gains

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["mini", "g1_fixture"])
def mjcf(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    return fx.write_mini_mjcf(d) if request.param == "mini" else fx.write_g1_fixture(d)


def test_physics_model_arrays_equal(mjcf):
    want = jax_build_model(mjcf)
    got = build_physics_model(mjcf)
    fields = [f for f in got.__dataclass_fields__]
    assert set(fields) <= set(want.__dataclass_fields__)
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, list):
            assert a == b, f
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f)


def test_g1_fixture_has_the_g1_widths(tmp_path):
    from add_gym_torch.physics.testing import MOTION_JOINT_ORDER

    model = build_physics_model(fx.write_g1_fixture(str(tmp_path)))
    assert (model.nb, model.nd) == (30, 29)
    assert sorted(model.joint_names) == sorted(MOTION_JOINT_ORDER)
    assert model.ncp > 200 and len(model.sc_pairs) > 50
    assert model.cp_explicit.sum() == 8   # four pads per foot


def test_fused_constants_equal(mjcf):
    want = JaxFMC(jax_build_model(mjcf))
    got = FusedModelConstants(build_physics_model(mjcf))
    for name in ("L", "C0", "C1", "C2", "IA_A", "IA_B", "IA_D"):
        np.testing.assert_array_equal(getattr(got, name), np.stack(getattr(want, name)), err_msg=name)
    for name in ("r", "axis", "mass", "armature", "damping", "friction", "lo", "hi",
                 "cp_body", "cp_pos", "cp_radius", "cp_mass", "cp_mass_local",
                 "cp_mass_stab", "cp_explicit", "sc_body", "sc_radius", "sc_pairs",
                 "sc_stiff_mass"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.sc_pos, np.asarray(want.sc_pos).reshape(-1, 3))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))

    from add_gym_tpu.physics.engine import EngineParams as JaxParams
    from add_gym_torch.physics.engine import EngineParams

    nd = got.nd
    jp = JaxParams(kp=jnp.ones(nd), kv=jnp.ones(nd))
    tp = EngineParams(kp=torch.ones(nd), kv=torch.ones(nd))
    for a, b in zip(want.contact_gains(jp, 0.0025), got.contact_gains(tp, 0.0025)):
        np.testing.assert_array_equal(b, a)


def test_pd_gains_equal(tmp_path):
    mjcf = fx.write_g1_fixture(str(tmp_path))
    for a, b in zip(jax_pd_gains(jax_build_model(mjcf)), build_pd_gains(build_physics_model(mjcf))):
        np.testing.assert_array_equal(b, a)


def test_pd_gains_need_tags_for_every_joint(tmp_path):
    model = build_physics_model(fx.write_mini_mjcf(str(tmp_path)))
    with pytest.raises(ValueError, match="without PD gain"):
        build_pd_gains(model)
    kp, kv = build_pd_gains(model, joint_cfg=[{"match": ".*leg_joint", "tags": ["hip"]}])
    np.testing.assert_allclose(kp, 80.0 * 1.2)
    np.testing.assert_allclose(kv, 2.0 * np.sqrt(kp))


def test_char_model_parse_and_conversions(mjcf):
    jc, tc = jax_load_char(mjcf), load_char_model(mjcf)
    for f in ("parent_indices", "local_translation", "local_rotation", "joint_types",
              "joint_axes", "dof_offsets"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    assert tc.body_names == jc.body_names and tc.joint_names == jc.joint_names
    assert tc.dof_size == jc.dof_size

    rng = np.random.default_rng(0)
    dof = rng.uniform(-1.5, 1.5, (16, tc.dof_size)).astype(np.float32)
    jr_j = jc.dof_to_rot(jnp.asarray(dof))
    jr_t = tc.dof_to_rot(torch.as_tensor(dof))
    np.testing.assert_allclose(jr_t.numpy(), np.asarray(jr_j), atol=1e-6)
    np.testing.assert_allclose(tc.rot_to_dof(jr_t).numpy(), np.asarray(jc.rot_to_dof(jr_j)),
                               atol=1e-6)
    dv_j = jc.compute_frame_dof_vel(jr_j, 1.0 / 30.0)
    dv_t = tc.compute_frame_dof_vel(jr_t, 1.0 / 30.0)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), atol=1e-4)
