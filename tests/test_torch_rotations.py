"""Port parity: ``add_gym_torch.mathx.rotations`` against the JAX library.

Every function runs on the same numpy inputs (seeded) in both packages.
Tolerance atol = 1e-6: both compute in f32 with the same formulas; XLA's
and torch's sin/cos/atan2/acos/sqrt differ by an ulp or two, which on
values up to pi is ~5e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import add_gym_tpu.mathx.rotations as jrot
import add_gym_torch.mathx.rotations as trot

torch.set_num_threads(2)

N = 64
ATOL = 1e-6


def _quat(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _angle(rng, n=N):
    return rng.uniform(-3.0, 3.0, n).astype(np.float32)


def _vec(rng, n=N):
    return rng.normal(size=(n, 3)).astype(np.float32)


def _exp_map(rng, n=N):
    v = _vec(rng, n)
    v[:4] *= 1e-7          # below the small-angle threshold
    return v


# name -> argument builder
CASES = {
    "normalize_angle": lambda r: (rng_angles(r),),
    "normalize": lambda r: (_vec(r),),
    "quat_unit": lambda r: (_quat(r) * 2.0,),
    "quat_conjugate": lambda r: (_quat(r),),
    "quat_pos": lambda r: (_quat(r),),
    "quat_mul": lambda r: (_quat(r), _quat(r)),
    "quat_rotate": lambda r: (_quat(r), _vec(r)),
    "quat_rotate_inv": lambda r: (_quat(r), _vec(r)),
    "quat_to_axis_angle": lambda r: (_quat(r),),
    "quat_to_matrix": lambda r: (_quat(r),),
    "matrix_to_quat": lambda r: (np.array(jrot.quat_to_matrix(_quat(r))),),
    "quat_to_euler_zyx": lambda r: (_quat(r),),
    "axis_angle_to_quat": lambda r: (_unit(r), _angle(r)),
    "quat_from_euler_xyz": lambda r: (_angle(r), _angle(r), _angle(r)),
    "quat_to_exp_map": lambda r: (_quat(r),),
    "exp_map_to_axis_angle": lambda r: (_exp_map(r),),
    "exp_map_to_quat": lambda r: (_exp_map(r),),
    "quat_diff": lambda r: (_quat(r), _quat(r)),
    "quat_diff_angle": lambda r: (_quat(r), _quat(r)),
    "quat_normalize": lambda r: (_quat(r) * 3.0,),
    "quat_to_tan_norm": lambda r: (_quat(r),),
    "slerp": lambda r: _slerp_args(r),
    "calc_heading": lambda r: (_quat(r),),
    "calc_heading_quat": lambda r: (_quat(r),),
    "calc_heading_quat_inv": lambda r: (_quat(r),),
    "quat_twist": lambda r: (_quat(r), _unit(r)),
    "quat_twist_angle": lambda r: (_quat(r), _unit(r)),
}


def rng_angles(r):
    return r.uniform(-20.0, 20.0, N).astype(np.float32)


def _slerp_args(r):
    q0, q1 = _quat(r), _quat(r)
    q1[:4] = q0[:4]                                   # identical endpoints
    q1[4:8] = -q0[4:8]                                # opposite hemispheres
    q1[8:12] = q0[8:12] + 1e-4                        # nearly identical
    t = r.uniform(0.0, 1.0, N).astype(np.float32)
    return q0, q1, t


def test_every_public_function_is_covered():
    public = {
        name for name in dir(jrot)
        if callable(getattr(jrot, name)) and not name.startswith("_")
    }
    assert public <= set(CASES), sorted(public - set(CASES))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rotation_parity(name):
    rng = np.random.default_rng(abs(hash(name)) % (2 ** 32))
    args = CASES[name](rng)
    want = getattr(jrot, name)(*(jnp.asarray(a) for a in args))
    got = getattr(trot, name)(*(torch.as_tensor(a) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=name)
