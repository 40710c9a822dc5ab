"""The port's native C++ loader (``add_gym_torch/native``).

* It builds with g++ into ``build/add_gym_torch/`` (never beside its
  source) and loads.
* ``parse_motion_csv`` equals ``np.loadtxt`` and the JAX package's native
  parser exactly on a synthetic clip, handles CRLF, missing final newlines
  and extra separators, and rejects ragged rows (``IOError``).
* ``stl_aabb`` equals the numpy reader (``physics/stl.py``) and the JAX
  package's exactly on the mesh fixture's STL boxes.
* The motion loader and the physics model builder go through it.
"""

import glob
import os

import numpy as np
import pytest

from add_gym_tpu import native as jax_native
from add_gym_torch import native
from add_gym_torch.motion import motion_file
from add_gym_torch.physics import testing as fx
from add_gym_torch.physics.stl import stl_aabb as py_stl_aabb


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    return dict(clip=fx.write_motion_csv(str(d / "clip.motion"), seed=8, num_frames=45),
                mesh=fx.write_mesh_fixture(str(d)), dir=str(d))


def test_builds_into_the_build_directory():
    assert native.available(), "the native loader did not build (g++ on PATH?)"
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("build", "add_gym_torch"))
    src_dir = os.path.dirname(native.SOURCE)
    assert not glob.glob(os.path.join(src_dir, "*.so"))


def test_csv_parity_with_numpy_and_jax(files):
    ref = np.loadtxt(files["clip"], delimiter=",", dtype=np.float64)
    got = native.parse_motion_csv(files["clip"])
    assert got.shape == ref.shape == (45, 36) and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_native.parse_motion_csv(files["clip"]))
    np.testing.assert_array_equal(motion_file.parse_motion_csv(files["clip"]), ref)


def test_csv_edge_cases(tmp_path):
    p = tmp_path / "edge.motion"
    p.write_text("1.0, 2.0, 3.0\r\n4,5,6\n7 , 8,\t9")
    np.testing.assert_array_equal(native.parse_motion_csv(str(p)),
                                  [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


def test_csv_ragged_rejected(tmp_path):
    p = tmp_path / "ragged.motion"
    p.write_text("1,2,3\n4,5\n")
    with pytest.raises(IOError):
        native.parse_motion_csv(str(p))


def test_stl_aabb_parity(files):
    stls = sorted(glob.glob(os.path.join(files["dir"], "*_vis.STL")))
    assert len(stls) == 30
    for path in stls:
        lo, hi = native.stl_aabb(path)
        lo_py, hi_py = py_stl_aabb(path)
        lo_j, hi_j = jax_native.stl_aabb(path)
        assert lo.dtype == hi.dtype == np.float32
        np.testing.assert_array_equal(lo, lo_py)
        np.testing.assert_array_equal(hi, hi_py)
        np.testing.assert_array_equal(lo, lo_j)
        np.testing.assert_array_equal(hi, hi_j)
        np.testing.assert_array_equal(lo, -hi)          # boxes centered on the origin


def test_loaders_route_through_native(files, monkeypatch):
    from add_gym_torch.physics import model as model_mod

    assert model_mod.stl_aabb is native.stl_aabb
    calls = []
    real = native.parse_motion_csv
    monkeypatch.setattr(native, "parse_motion_csv", lambda p: calls.append(p) or real(p))
    clip = motion_file.load_motion(files["clip"])
    assert calls == [files["clip"]] and clip.frames.shape == (45, 36)
