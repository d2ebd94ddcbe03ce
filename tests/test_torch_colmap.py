"""The port's COLMAP ingestion (``io/colmap.py``) on the CPU, held to the
JAX package's exactly on the same bytes, mirroring every non-slow test of
``tests/test_colmap.py``. Fixtures are written by the tests themselves:
the two packages' writers must produce the same bytes, and both packages'
readers read them.

Tolerances: everything read, written, undistorted or initialised equal
between the packages; the pose and undistortion checks keep
``test_colmap.py``'s own (view 1e-5, vp 1e-4, inversion 1e-9, resampled
interior 6e-3).
"""

import os
import struct

import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu.io import colmap as jcm

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.io import colmap as cm
from openglgaussiansplattingrenderer_tpu_torch.io import dataset as ds
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _gl_c2w(pos, yaw_deg):
    a = np.deg2rad(yaw_deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    m[:3, 3] = pos
    return m


def _colmap_pose_from_gl(c2w_gl):
    w2c = np.linalg.inv(c2w_gl @ np.diag([1.0, -1.0, -1.0, 1.0]))
    q = cm.rotmat2qvec(w2c[:3, :3])
    np.testing.assert_array_equal(q, jcm.rotmat2qvec(w2c[:3, :3]))
    return q, w2c[:3, 3]


def _write_model(d, poses, w=64, h=48, fl=70.0, names=None, xyz=None, rgb=None,
                 mod=cm):
    cams = {1: {"model": "PINHOLE", "width": w, "height": h,
                "params": np.array([fl, fl, w / 2.0, h / 2.0])}}
    mod.write_cameras_bin(os.path.join(d, "cameras.bin"), cams)
    images = [{"image_id": i + 1, "qvec": q, "tvec": t, "camera_id": 1,
               "name": (names[i] if names else f"im{i:03d}.png")}
              for i, (q, t) in enumerate(poses)]
    mod.write_images_bin(os.path.join(d, "images.bin"), images)
    if xyz is None:
        xyz, rgb = np.zeros((1, 3)), np.zeros((1, 3), np.uint8)
    mod.write_points3d_bin(os.path.join(d, "points3D.bin"), xyz, rgb)


def _assert_same(got, want, path="value"):
    """Equal structures of dicts, lists, tuples, arrays and scalars."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def test_writers_write_the_jax_bytes(tmp_path):
    poses = [_colmap_pose_from_gl(_gl_c2w([0.5, -0.2, -4.0], 25.0))]
    xyz = np.random.default_rng(0).normal(0, 1, (5, 3))
    rgb = np.arange(15, dtype=np.uint8).reshape(5, 3)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _write_model(str(tmp_path / "a"), poses, xyz=xyz, rgb=rgb)
    _write_model(str(tmp_path / "b"), poses, xyz=xyz, rgb=rgb, mod=jcm)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f


def test_pose_roundtrip_binary(tmp_path):
    c2ws = [_gl_c2w([0.5, -0.2, -4.0], 25.0), _gl_c2w([-1.0, 0.3, -3.0], -40.0)]
    _write_model(str(tmp_path), [_colmap_pose_from_gl(m) for m in c2ws])
    got = cm.load_colmap(str(tmp_path), load_images=False)
    _assert_same(got, jcm.load_colmap(str(tmp_path), load_images=False))
    bundles = got[0]
    assert len(bundles) == 2
    for b, c2w in zip(bundles, c2ws):
        want = ds.bundle_from_c2w(c2w, 64, 48, fl_x=70.0, fl_y=70.0)
        np.testing.assert_allclose(b["view"], want["view"], atol=1e-5)
        np.testing.assert_allclose(b["vp"], want["vp"], atol=1e-4)
        assert b["width"] == 64 and b["height"] == 48
        np.testing.assert_allclose(b["tan_fovx"], want["tan_fovx"])


def test_binary_and_text_readers_agree(tmp_path):
    poses = [_colmap_pose_from_gl(_gl_c2w([0, 0, -3.0], 10.0))]
    xyz = np.array([[0.1, 0.2, 0.3], [-1.0, 0.5, 2.0]])
    rgb = np.array([[255, 0, 10], [0, 128, 255]], np.uint8)
    _write_model(str(tmp_path), poses, xyz=xyz, rgb=rgb)
    q, t = poses[0]
    (tmp_path / "cameras.txt").write_text("# comment\n1 PINHOLE 64 48 70.0 70.0 32.0 24.0\n")
    (tmp_path / "images.txt").write_text(
        "# comment\n1 " + " ".join(f"{v:.17g}" for v in [*q, *t]) + " 1 im000.png\n\n")
    (tmp_path / "points3D.txt").write_text("# comment\n" + "".join(
        f"{i} {xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]} {rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]} 0.5 \n"
        for i in range(2)))
    for kind in ("cameras", "images", "points3d"):
        for ext in ("bin", "txt"):
            f = str(tmp_path / f"{'points3D' if kind == 'points3d' else kind}.{ext}")
            got = getattr(cm, f"read_{kind}_{ext}")(f)
            _assert_same(got, getattr(jcm, f"read_{kind}_{ext}")(f), f)
    cb, ct = cm.read_cameras_bin(str(tmp_path / "cameras.bin")), cm.read_cameras_txt(
        str(tmp_path / "cameras.txt"))
    np.testing.assert_allclose(cb[1]["params"], ct[1]["params"])
    ib, it = cm.read_images_bin(str(tmp_path / "images.bin")), cm.read_images_txt(
        str(tmp_path / "images.txt"))
    np.testing.assert_allclose(ib[0]["qvec"], it[0]["qvec"], atol=1e-12)
    np.testing.assert_allclose(ib[0]["tvec"], it[0]["tvec"], atol=1e-12)
    xb, rb, _ = cm.read_points3d_bin(str(tmp_path / "points3D.bin"))
    xt, rt, _ = cm.read_points3d_txt(str(tmp_path / "points3D.txt"))
    np.testing.assert_allclose(xb, xt)
    np.testing.assert_array_equal(rb, rt)
    # the text model loads as the binary one does, in both packages
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        os.rename(tmp_path / f, tmp_path / (f + ".off"))
    _assert_same(cm.load_colmap(str(tmp_path), load_images=False),
                 jcm.load_colmap(str(tmp_path), load_images=False))


def test_render_through_colmap_pose(tmp_path):
    """A splat on the camera axis lands at the image centre through a
    COLMAP-loaded pose: the convention checked by pixels."""
    _write_model(str(tmp_path), [_colmap_pose_from_gl(np.eye(4))], w=64, h=64, fl=64.0)
    b = cm.load_colmap(str(tmp_path), load_images=False)[0][0]
    scene = ply_io.make_synthetic_scene(1, seed=0, extent=0.0)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    scene["means"] = np.array([[0.0, 0.0, -3.0]], np.float32)
    scene["scales"] = np.full((1, 3), 0.08, np.float32)
    scene["opacities"] = np.array([0.9], np.float32)
    cfg = port.RenderConfig.for_resolution(64, 64, tile_px=32, use_pallas=False,
                                           max_per_tile=256, chunk=64,
                                           dup_capacity_factor=64.0)
    img, _ = render_arrays(convert.params_from_numpy(scene, "cpu"), b["view"], b["vp"],
                           b["focal_x"], b["focal_y"], b["tan_fovx"], b["tan_fovy"],
                           64, 64, cfg)
    img = img[..., :3].sum(-1).numpy()
    assert img.max() > 0.05, "splat not visible through the COLMAP pose"
    cy, cx = np.unravel_index(np.argmax(img), img.shape)
    assert abs(cx - 32) <= 1 and abs(cy - 32) <= 1, (cx, cy)


def test_init_params_from_points():
    rng = np.random.default_rng(0)
    xyz = rng.normal(0, 1, (200, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (200, 3)).astype(np.float32)
    p = cm.init_params_from_points(xyz, rgb, opacity=0.1)
    _assert_same(p, jcm.init_params_from_points(xyz, rgb, opacity=0.1))
    assert p["means"].shape == (200, 3)
    np.testing.assert_allclose(p["colors"], rgb)
    assert (p["opacities"] == np.float32(0.1)).all()
    np.testing.assert_allclose(np.linalg.norm(p["quats"], axis=1), 1.0)
    tight = np.concatenate([xyz, xyz[:50] + 1e-3], axis=0)
    p2 = cm.init_params_from_points(tight, np.concatenate([rgb, rgb[:50]], axis=0))
    assert p2["scales"][:50].mean() < p["scales"][:50].mean()
    p3 = cm.init_params_from_points(xyz, rgb, max_points=64, seed=3)
    _assert_same(p3, jcm.init_params_from_points(xyz, rgb, max_points=64, seed=3))
    assert p3["means"].shape == (64, 3)
    with pytest.raises(ValueError, match="empty"):
        cm.init_params_from_points(np.zeros((0, 3)), np.zeros((0, 3)))


def test_distortion_warning(tmp_path):
    cams = {1: {"model": "SIMPLE_RADIAL", "width": 64, "height": 48,
                "params": np.array([70.0, 32.0, 24.0, 0.05])}}
    cm.write_cameras_bin(str(tmp_path / "cameras.bin"), cams)
    q, t = _colmap_pose_from_gl(_gl_c2w([0, 0, -3.0], 0.0))
    cm.write_images_bin(str(tmp_path / "images.bin"), [
        {"image_id": 1, "qvec": q, "tvec": t, "camera_id": 1, "name": "a.png"}])
    cm.write_points3d_bin(str(tmp_path / "points3D.bin"), np.zeros((1, 3)),
                          np.zeros((1, 3), np.uint8))
    with pytest.warns(RuntimeWarning, match="distortion"):
        got = cm.load_colmap(str(tmp_path), load_images=False)
    with pytest.warns(RuntimeWarning, match="distortion"):
        _assert_same(got, jcm.load_colmap(str(tmp_path), load_images=False))


@pytest.mark.parametrize("model,dist", [
    ("SIMPLE_RADIAL", (0.08,)),
    ("RADIAL", (0.06, -0.02)),
    ("OPENCV", (0.05, -0.01, 0.004, -0.003)),
    ("FULL_OPENCV", (0.05, -0.01, 0.004, -0.003, 0.001, 0.01, -0.002, 0.0005)),
])
def test_undistort_normalized_inverts_forward(model, dist):
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-0.4, 0.4, 500), rng.uniform(-0.3, 0.3, 500)
    xd, yd = cm.distort_normalized(x, y, model, dist)
    _assert_same((xd, yd), jcm.distort_normalized(x, y, model, dist))
    xu, yu = cm.undistort_normalized(xd, yd, model, dist)
    _assert_same((xu, yu), jcm.undistort_normalized(xd, yd, model, dist))
    np.testing.assert_allclose(xu, x, atol=1e-9)
    np.testing.assert_allclose(yu, y, atol=1e-9)


def _ideal_image(w, h):
    u, v = np.meshgrid(np.arange(w) / w, np.arange(h) / h)
    return np.stack([0.5 + 0.4 * np.sin(4.0 * u + 1.0) * np.cos(3.0 * v),
                     0.5 + 0.4 * np.cos(5.0 * u * v + 2.0),
                     u * 0.6 + v * 0.3], axis=-1).astype(np.float32)


def _distorted_capture(ideal, cam):
    fx, fy, cx, cy, dist = cm._split_intrinsics(cam)
    h, w = ideal.shape[:2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xn, yn = cm.undistort_normalized((u - cx) / fx, (v - cy) / fy, cam["model"], dist)
    return cm._bilinear_sample(ideal, xn * fx + w / 2.0, yn * fy + h / 2.0).astype(np.float32)


def test_undistort_image_recovers_pinhole():
    w, h, fl = 96, 72, 90.0
    cam = {"model": "SIMPLE_RADIAL", "width": w, "height": h,
           "params": np.array([fl, w / 2.0 + 1.5, h / 2.0 - 1.0, 0.07])}
    ideal = _ideal_image(w, h)
    captured = _distorted_capture(ideal, cam)
    assert np.abs(captured - ideal)[10:-10, 10:-10].max() > 0.02
    out = cm.undistort_image(captured, cam)
    _assert_same(out, jcm.undistort_image(captured, cam))
    err = np.abs(out - ideal)[10:-10, 10:-10]
    assert err.max() < 6e-3, err.max()
    ucam = cm.undistorted_camera(cam)
    _assert_same(ucam, jcm.undistorted_camera(cam))
    assert ucam["model"] == "PINHOLE"
    np.testing.assert_allclose(ucam["params"], [fl, fl, w / 2.0, h / 2.0])
    with pytest.raises(ValueError, match="unsupported"):
        cm.undistorted_camera({"model": "FOV", "params": np.zeros(5)})


def test_load_undistorts_a_raw_workspace(tmp_path):
    """A distorted workspace with images on disk loads undistorted, with
    pinhole bundles and no warning, the same in both packages."""
    w, h, fl = 64, 48, 70.0
    ws = tmp_path / "capture"
    (ws / "sparse" / "0").mkdir(parents=True)
    (ws / "images").mkdir()
    cam = {"model": "SIMPLE_RADIAL", "width": w, "height": h,
           "params": np.array([fl, w / 2.0, h / 2.0, 0.35])}
    cm.write_cameras_bin(str(ws / "sparse" / "0" / "cameras.bin"), {1: cam})
    c2ws = [_gl_c2w([0, 0, 4.0], 0.0), _gl_c2w([1.2, 0, 3.8], 17.0)]
    cm.write_images_bin(str(ws / "sparse" / "0" / "images.bin"), [
        {"image_id": i + 1, "qvec": q, "tvec": t, "camera_id": 1, "name": f"v{i}.png"}
        for i, (q, t) in enumerate(_colmap_pose_from_gl(m) for m in c2ws)])
    cm.write_points3d_bin(str(ws / "sparse" / "0" / "points3D.bin"),
                          np.random.default_rng(1).normal(0, 1, (6, 3)),
                          np.full((6, 3), 200, np.uint8))
    for i in range(2):
        save_png(str(ws / "images" / f"v{i}.png"),
                 _distorted_capture(_ideal_image(w, h), cam))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = cm.load_colmap(str(ws / "sparse" / "0"))
        _assert_same(got, jcm.load_colmap(str(ws / "sparse" / "0")))
    assert all(im is not None and im.shape == (h, w, 3) for im in got[1])


def test_parse_foreign_colmap_bytes(tmp_path):
    """A binary model packed field by field from COLMAP's published format
    (read_write_model.py), with 2D point lists and tracks that this repo's
    writers never emit, parses the same in both packages."""
    sp = tmp_path / "sparse" / "0"
    sp.mkdir(parents=True)
    with open(sp / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 2, 640, 480))
        for p in (525.5, 320.0, 240.0, -0.071):
            f.write(struct.pack("<d", p))
    qvecs = [(1.0, 0.0, 0.0, 0.0), (0.9961946980917455, 0.08715574274765817, 0.0, 0.0)]
    tvecs = [(0.1, -0.2, 2.5), (-0.3, 0.05, 2.4)]
    with open(sp / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for i, (q, t) in enumerate(zip(qvecs, tvecs)):
            f.write(struct.pack("<i", 7 + i) + struct.pack("<dddd", *q)
                    + struct.pack("<ddd", *t) + struct.pack("<i", 1))
            f.write(f"frame_{i:04d}.png".encode() + b"\x00" + struct.pack("<Q", 3))
            for j in range(3):
                f.write(struct.pack("<dd", 10.0 * j, 20.0 * j)
                        + struct.pack("<q", j if j < 2 else -1))
    pts = [((1.25, -0.5, 3.0), (200, 10, 30), 0.81), ((-0.75, 0.25, 2.0), (15, 250, 120), 1.5)]
    with open(sp / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for pid, (xyz, rgb, err) in enumerate(pts):
            f.write(struct.pack("<q", 100 + pid) + struct.pack("<ddd", *xyz)
                    + struct.pack("<BBB", *rgb) + struct.pack("<d", err)
                    + struct.pack("<Q", 2))
            for im, p2 in ((7, 0), (8, 1)):
                f.write(struct.pack("<ii", im, p2))

    cams = cm.read_cameras_bin(str(sp / "cameras.bin"))
    _assert_same(cams, jcm.read_cameras_bin(str(sp / "cameras.bin")))
    assert cams[1]["model"] == "SIMPLE_RADIAL"
    assert (cams[1]["width"], cams[1]["height"]) == (640, 480)
    imgs = cm.read_images_bin(str(sp / "images.bin"))
    _assert_same(imgs, jcm.read_images_bin(str(sp / "images.bin")))
    assert [im["image_id"] for im in imgs] == [7, 8]
    assert [im["name"] for im in imgs] == ["frame_0000.png", "frame_0001.png"]
    got = cm.read_points3d_bin(str(sp / "points3D.bin"))
    _assert_same(got, jcm.read_points3d_bin(str(sp / "points3D.bin")))
    np.testing.assert_allclose(got[0], [p[0] for p in pts])
    np.testing.assert_array_equal(got[1], [p[1] for p in pts])
    with pytest.warns(RuntimeWarning):
        b = cm.bundle_from_colmap_pose(imgs[1]["qvec"], imgs[1]["tvec"], cams[1])
    with pytest.warns(RuntimeWarning):
        _assert_same(b, jcm.bundle_from_colmap_pose(imgs[1]["qvec"], imgs[1]["tvec"],
                                                    cams[1]))
    c, s = np.cos(np.deg2rad(10)), np.sin(np.deg2rad(10))
    np.testing.assert_allclose(cm.qvec2rotmat(imgs[1]["qvec"]),
                               [[1, 0, 0], [0, c, -s], [0, s, c]], atol=1e-12)
    _assert_same(cm.qvec2rotmat(imgs[1]["qvec"]), jcm.qvec2rotmat(imgs[1]["qvec"]))
