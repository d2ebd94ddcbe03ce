"""The port's native C++ PLY loader (``io/native.py``) against its numpy
loader, field for field (oracle pattern #2).

Mirrors ``tests/test_native_loader.py``, skip guard included: the library
is built with g++ at first use into the port's ``csrc/build/``; where that
fails the native tests skip and ``load_splats`` reads through numpy.
"""

import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply

from openglgaussiansplattingrenderer_tpu_torch.io import native, ply as ply_io


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native loader could not be built (g++)")


def _write(tmp_path, n, seed, sh=False):
    scene = ply_io.make_synthetic_scene(n, seed=seed)
    path = str(tmp_path / "scene.ply")
    ply_io.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                    scene["opacities"], scene["colors"],
                    scene["sh_rest"] if sh else None)
    return scene, path


@pytest.mark.parametrize("sh", [False, True], ids=["zero f_rest", "random f_rest"])
def test_native_matches_numpy(tmp_path, lib_available, sh):
    n = 1234
    _, path = _write(tmp_path, n, 77, sh)
    got = native.load_splats(path)
    assert got is not None
    want = ply_io.activate(ply_io.load_ply(path))
    assert set(got) == set(want)
    for k in ["means", "colors", "opacities", "scales"]:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.abs(np.sum(got["quats"] * want["quats"], axis=1)),
                               1.0, atol=1e-5)
    assert got["sh_rest"].shape == (n, 45)
    np.testing.assert_allclose(got["sh_rest"], want["sh_rest"], atol=1e-6)
    # the JAX package's native loader reads the same file the same way
    want_j = jax_ply.load_splats(path)
    for k in want_j:
        np.testing.assert_allclose(got[k], want_j[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_native_missing_file(lib_available):
    with pytest.raises(FileNotFoundError):
        native.load_splats("/nonexistent/scene.ply")


def test_native_declines_a_nonstandard_layout(tmp_path, lib_available):
    # a vertex without the 3DGS properties: the native loader returns None,
    # and load_splats reads it through the numpy parser's error
    path = tmp_path / "xyz.ply"
    path.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                     b"property float x\nproperty float y\nproperty float z\n"
                     b"end_header\n" + np.zeros(3, np.float32).tobytes())
    assert native.load_splats(str(path)) is None
    with pytest.raises(Exception):
        ply_io.load_splats(str(path))


def test_load_splats_dispatch(tmp_path):
    """``io.ply.load_splats`` takes the native path when it builds and must
    give the same result either way."""
    scene, path = _write(tmp_path, 50, 5)
    out = ply_io.load_splats(path)
    np.testing.assert_allclose(out["means"], scene["means"], atol=1e-6)
    want = ply_io.activate(ply_io.load_ply(path))
    for k in want:
        np.testing.assert_allclose(out[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
