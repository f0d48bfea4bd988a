"""The port's native host runtime (io/native.py: ctypes bindings of
native/tiray_native.cpp, compiled with g++ into the package's own build
directory) against its pure-Python oracle and against the JAX package's
loader: OBJ parses equal array for array, morton codes equal but for
points on a quantisation boundary (the native code multiplies by the
reciprocal of the extent, utils/morton divides; at most 0.1% of codes,
the bar of the reference's tests/test_native.py).  Skips where g++ is
missing, as the reference's test does.
"""

import os

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.io import native, obj
from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.utils.morton import morton3d

needs_lib = pytest.mark.skipif(native.get_lib() is None, reason="native toolchain unavailable")
MODELS = ["cornell_box.obj", "Teapot.obj", "bdpt.obj"]


def _assert_mesh_equal(a, b, exact_params=False):
    assert [m.name for m in a.materials] == [m.name for m in b.materials]
    for ma, mb in zip(a.materials, b.materials):
        for f in ("diffuse", "emissive", "shininess", "optical_density", "transparency"):
            x, y = np.float64(getattr(ma, f)), np.float64(getattr(mb, f))
            if exact_params:
                np.testing.assert_array_equal(x, y, f)
            else:  # the native parser keeps f32 parameters
                np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=f)
    for name in ("tri_pos", "tri_normal", "tri_uv"):
        for pa, pb in zip(getattr(a, name), getattr(b, name)):
            assert pa.dtype == pb.dtype and pa.shape == pb.shape and pa.tobytes() == pb.tobytes()


@needs_lib
@pytest.mark.parametrize("model", MODELS)
def test_native_obj_matches_python(model):
    path = asset_path(f"model/{model}")
    _assert_mesh_equal(native.load_obj_native(path), obj._load_obj_py(path))


@needs_lib
@pytest.mark.parametrize("model", MODELS)
def test_load_obj_matches_reference(model, monkeypatch):
    """load_obj (the native parser) against the reference's load_obj, and
    TIRAY_NO_NATIVE=1 takes the Python parser."""
    from ti_raytrace_tpu.io.obj import load_obj as jload

    path = asset_path(f"model/{model}")
    got = obj.load_obj(path)
    _assert_mesh_equal(got, jload(path), exact_params=True)
    assert got.triangle_count() == sum(p.shape[0] for p in got.tri_pos) > 0
    monkeypatch.setenv("TIRAY_NO_NATIVE", "1")
    monkeypatch.setattr(native, "load_obj_native", lambda p: pytest.fail("native parser used"))
    _assert_mesh_equal(obj.load_obj(path), got)


@needs_lib
def test_native_morton_matches_morton3d():
    rng = np.random.default_rng(0)
    c = rng.uniform(-3, 7, (5000, 3)).astype(np.float32)
    lo, hi = c.min(0), c.max(0)
    got = native.morton3d_native(c, lo, hi)
    q = torch.from_numpy((c - lo) / np.maximum(hi - lo, 1e-12))
    want = morton3d(q[:, 0], q[:, 1], q[:, 2]).numpy()
    assert got.dtype == np.uint32 and (got != want).mean() < 0.001


@needs_lib
def test_library_lives_in_the_package_build_dir():
    """The library is built into ops/cuda_build.BUILD_DIR under a hash of
    source and flags, never into native/build/."""
    from ti_raytrace_tpu_torch.ops.cuda_build import BUILD_DIR

    path = native.library_path()
    assert os.path.dirname(path) == BUILD_DIR and os.path.exists(path)
    assert native.get_lib() is native.get_lib()
    assert os.path.basename(path).startswith("tiray_native-") and path.endswith(".so")
