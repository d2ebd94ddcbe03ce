"""COLMAP sparse-reconstruction ingestion (binary and text formats).

Counterpart of ``openglgaussiansplattingrenderer_tpu/io/colmap.py``: a
numpy copy (readers, writers, undistortion and the SfM initialisation)
on the port's ``io/dataset`` and ``io/png``.

Real 3DGS training starts from a COLMAP sparse model: per-image poses
(``images.bin``), camera intrinsics (``cameras.bin``) and a seed point
cloud (``points3D.bin``). The reference renders pre-trained PLYs only;
this module (capability beyond it) turns a COLMAP model into the camera
bundles ``trainer.fit_scene`` consumes plus 3DGS-style initial splat
parameters from the sparse points (Kerbl et al. sec. 4: positions from
SfM, scales from mean nearest-neighbor distance, opacity 0.1).

Format layout follows COLMAP's own ``read_write_model.py`` documentation
of the binary schema (little-endian; cameras: id/model/width/height/params,
images: id/qvec/tvec/camera_id/name/points2D, points3D:
id/xyz/rgb/error/track).

Conventions: COLMAP camera frames are OpenCV-style (x right, y down,
z forward) with world-to-camera ``X_cam = R(qvec) @ X_world + tvec``. The
renderer wants OpenGL-frame matrices (``io/dataset.py``), so
``c2w_gl = inv([R|t]) @ diag(1, -1, -1, 1)``. Principal points must be
(near-)centered and distortion zero -- run COLMAP's ``image_undistorter``
first for real captures; a loud warning is raised otherwise.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from openglgaussiansplattingrenderer_tpu_torch.io.dataset import bundle_from_c2w
from openglgaussiansplattingrenderer_tpu_torch.io.png import load_png

# model_id -> (name, num_params); params orders per COLMAP docs
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """3x3 rotation -> COLMAP (w, x, y, z) quaternion (tests/export)."""
    m = np.asarray(r, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


# --- binary readers ---------------------------------------------------------

def _read(f, fmt):
    return struct.unpack("<" + fmt, f.read(struct.calcsize("<" + fmt)))


def read_cameras_bin(path: str) -> Dict[int, Dict]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params))
            cams[cam_id] = {"model": name, "width": int(w), "height": int(h),
                            "params": params}
    return cams


def read_images_bin(path: str) -> List[Dict]:
    images = []
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            vals = _read(f, "idddddddi")
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00" or not c:
                    break
                name += c
            (n_pts,) = _read(f, "Q")
            f.seek(n_pts * 24, os.SEEK_CUR)        # (x, y, point3D_id) each
            images.append({
                "image_id": image_id,
                "qvec": np.array([qw, qx, qy, qz]),
                "tvec": np.array([tx, ty, tz]),
                "camera_id": cam_id,
                "name": name.decode("utf-8"),
            })
    return images


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64)."""
    xyz, rgb, err = [], [], []
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            vals = _read(f, "QdddBBBd")
            xyz.append(vals[1:4])
            rgb.append(vals[4:7])
            err.append(vals[7])
            (track_len,) = _read(f, "Q")
            f.seek(track_len * 8, os.SEEK_CUR)     # (image_id, point2D_idx)
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(rgb, np.uint8).reshape(-1, 3),
            np.asarray(err, np.float64))


# --- text readers (COLMAP `model_converter --output_type TXT`) --------------

def _txt_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_txt(path: str) -> Dict[int, Dict]:
    cams = {}
    for line in _txt_lines(path):
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        cams[cam_id] = {"model": model, "width": int(parts[2]),
                        "height": int(parts[3]),
                        "params": np.array([float(p) for p in parts[4:]])}
    return cams


def read_images_txt(path: str) -> List[Dict]:
    images = []
    for i, line in enumerate(_txt_lines(path)):
        if i % 2 == 1:      # second line per image = 2D points; skip
            continue
        parts = line.split()
        images.append({
            "image_id": int(parts[0]),
            "qvec": np.array([float(p) for p in parts[1:5]]),
            "tvec": np.array([float(p) for p in parts[5:8]]),
            "camera_id": int(parts[8]),
            "name": parts[9] if len(parts) > 9 else "",
        })
    return images


def read_points3d_txt(path: str):
    xyz, rgb, err = [], [], []
    for line in _txt_lines(path):
        parts = line.split()
        xyz.append([float(p) for p in parts[1:4]])
        rgb.append([int(p) for p in parts[4:7]])
        err.append(float(parts[7]))
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(rgb, np.uint8).reshape(-1, 3),
            np.asarray(err, np.float64))


# --- undistortion ------------------------------------------------------------
#
# Nearly every raw COLMAP reconstruction uses a distorted model
# (SIMPLE_RADIAL by default); the renderer's EWA projection is pinhole.
# ``load_colmap(undistort=True)`` resamples each capture image onto an ideal
# pinhole camera (same focal, centered principal point) -- the same job as
# COLMAP's ``image_undistorter`` -- so training runs directly off a raw
# workspace. Distortion conventions follow COLMAP's camera model docs
# (src/base/camera_models.h): normalized coords, radial polynomial in r^2,
# OpenCV tangential terms.

_DISTORTED_MODELS = ("SIMPLE_RADIAL", "RADIAL", "OPENCV", "FULL_OPENCV")


def _split_intrinsics(cam: Dict):
    """-> (fx, fy, cx, cy, dist tuple) for the supported models."""
    p = cam["params"]
    model = cam["model"]
    if model == "SIMPLE_PINHOLE":
        return p[0], p[0], p[1], p[2], ()
    if model == "PINHOLE":
        return p[0], p[1], p[2], p[3], ()
    if model in ("SIMPLE_RADIAL", "RADIAL"):
        return p[0], p[0], p[1], p[2], tuple(p[3:])
    if model in ("OPENCV", "FULL_OPENCV"):
        return p[0], p[1], p[2], p[3], tuple(p[4:])
    raise ValueError(f"unsupported COLMAP camera model {model!r}; "
                     "run COLMAP image_undistorter to get PINHOLE")


def distort_normalized(x: np.ndarray, y: np.ndarray, model: str,
                       dist: Tuple[float, ...]):
    """Apply the model's distortion to normalized camera coords (forward)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    r2 = x * x + y * y
    if model == "SIMPLE_RADIAL":
        (k,) = dist
        f = 1.0 + k * r2
        return x * f, y * f
    if model == "RADIAL":
        k1, k2 = dist
        f = 1.0 + r2 * (k1 + k2 * r2)
        return x * f, y * f
    if model in ("OPENCV", "FULL_OPENCV"):
        k1, k2, p1, p2 = dist[:4]
        extra = dist[4:]  # FULL_OPENCV: k3..k6
        f = 1.0 + r2 * (k1 + k2 * r2)
        if extra:
            k3, k4, k5, k6 = extra
            f = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / \
                (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6)))
        xd = x * f + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * f + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return xd, yd
    raise ValueError(f"no distortion for model {model!r}")


def undistort_normalized(xd: np.ndarray, yd: np.ndarray, model: str,
                         dist: Tuple[float, ...], iters: int = 20):
    """Invert the distortion (fixed-point iteration, as COLMAP's
    ``IterativeUndistortion``): find (x, y) with distort(x, y) == (xd, yd).

    Needed when mapping distorted observations (2D feature points) back to
    rays; image undistortion itself only needs the forward map."""
    x = np.asarray(xd, np.float64).copy()
    y = np.asarray(yd, np.float64).copy()
    for _ in range(iters):
        dx, dy = distort_normalized(x, y, model, dist)
        x += np.asarray(xd) - dx
        y += np.asarray(yd) - dy
    return x, y


def _bilinear_sample(img: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Sample (H, W, C) at float pixel coords (u=x, v=y); border-clamped."""
    h, w = img.shape[:2]
    u = np.clip(u, 0.0, w - 1.0)
    v = np.clip(v, 0.0, h - 1.0)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return ((img[v0, u0] * (1 - fu) + img[v0, u1] * fu) * (1 - fv)
            + (img[v1, u0] * (1 - fu) + img[v1, u1] * fu) * fv)


def undistort_image(img: np.ndarray, cam: Dict) -> np.ndarray:
    """Resample a distorted capture onto the ideal pinhole camera
    ``undistorted_camera(cam)`` (same focal, centered principal point).

    For every output pixel: pinhole ray -> forward distortion -> source
    pixel in the capture -> bilinear sample. No iteration is needed in this
    direction. Output dtype float32, same (H, W, C)."""
    fx, fy, cx, cy, dist = _split_intrinsics(cam)
    h, w = img.shape[:2]
    cx_o, cy_o = w / 2.0, h / 2.0
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xn = (u - cx_o) / fx
    yn = (v - cy_o) / fy
    xd, yd = distort_normalized(xn, yn, cam["model"], dist)
    return _bilinear_sample(np.asarray(img, np.float32),
                            xd * fx + cx, yd * fy + cy).astype(np.float32)


def undistorted_camera(cam: Dict) -> Dict:
    """The ideal PINHOLE camera ``undistort_image`` resamples onto."""
    fx, fy, _, _, _ = _split_intrinsics(cam)
    return {"model": "PINHOLE", "width": cam["width"],
            "height": cam["height"],
            "params": np.array([fx, fy, cam["width"] / 2.0,
                                cam["height"] / 2.0])}


# --- model -> renderer ------------------------------------------------------

def _intrinsics(cam: Dict) -> Tuple[float, float]:
    """(fl_x, fl_y) in pixels; warns on off-center principal point or
    nonzero distortion (load through ``load_colmap(undistort=True)`` or
    COLMAP's image_undistorter instead of hitting these warnings)."""
    fx, fy, cx, cy, dist = _split_intrinsics(cam)
    if any(abs(d) > 1e-8 for d in np.atleast_1d(dist)):
        warnings.warn(
            f"COLMAP model {cam['model']} has nonzero distortion {dist}; the "
            "renderer is distortion-free -- undistort the capture first "
            "(COLMAP image_undistorter). Proceeding as pinhole.",
            RuntimeWarning, stacklevel=3)
    if (abs(cx - cam["width"] / 2.0) > 1.0
            or abs(cy - cam["height"] / 2.0) > 1.0):
        warnings.warn(
            f"principal point ({cx:.1f}, {cy:.1f}) is off-center for "
            f"{cam['width']}x{cam['height']}; the projection assumes a "
            "centered principal point -- expect a constant pixel shift.",
            RuntimeWarning, stacklevel=3)
    return float(fx), float(fy)


def bundle_from_colmap_pose(qvec, tvec, cam: Dict) -> Dict[str, np.ndarray]:
    """One COLMAP (qvec, tvec, camera) -> render argument bundle."""
    r = qvec2rotmat(qvec)
    w2c = np.eye(4)
    w2c[:3, :3] = r
    w2c[:3, 3] = np.asarray(tvec, np.float64)
    c2w_cv = np.linalg.inv(w2c)
    c2w_gl = c2w_cv @ np.diag([1.0, -1.0, -1.0, 1.0])  # OpenCV -> OpenGL cam
    fl_x, fl_y = _intrinsics(cam)
    return bundle_from_c2w(c2w_gl, cam["width"], cam["height"],
                           fl_x=fl_x, fl_y=fl_y)


def _needs_undistort(cam: Dict) -> bool:
    try:
        _, _, cx, cy, dist = _split_intrinsics(cam)
    except ValueError:
        return False  # fisheye etc. -- _intrinsics will raise loudly
    return (any(abs(d) > 1e-10 for d in dist)
            or abs(cx - cam["width"] / 2.0) > 0.5
            or abs(cy - cam["height"] / 2.0) > 0.5)


def load_colmap(
    sparse_dir: str,
    images_dir: Optional[str] = None,
    load_images: bool = True,
    undistort: bool = True,
) -> Tuple[List[Dict[str, np.ndarray]], List[Optional[np.ndarray]], Dict]:
    """Load a COLMAP model directory (binary or text, auto-detected).

    Returns (bundles, images, points) where ``points`` is
    {"xyz": (N, 3) f32, "rgb": (N, 3) f32 in 0..255, "error": (N,)}.
    ``images_dir`` defaults to ``<sparse_dir>/../../images`` (the standard
    COLMAP workspace layout); missing image files yield None entries.

    With ``undistort`` (default), SIMPLE_RADIAL / RADIAL / OPENCV captures
    -- i.e. nearly every raw COLMAP reconstruction -- are resampled onto
    ideal pinhole cameras at load (``undistort_image``; also recenters
    off-center principal points), so training runs directly off a raw
    workspace with no COLMAP ``image_undistorter`` step. Images that cannot
    be loaded fall back to the pinhole-approximation warning path.
    """
    def pick(stem):
        for ext, readers in (
            (".bin", (read_cameras_bin, read_images_bin, read_points3d_bin)),
            (".txt", (read_cameras_txt, read_images_txt, read_points3d_txt)),
        ):
            p = os.path.join(sparse_dir, stem + ext)
            if os.path.exists(p):
                return p, readers[("cameras", "images", "points3D").index(stem)]
        raise FileNotFoundError(f"no {stem}.bin/.txt in {sparse_dir}")

    cam_path, cam_reader = pick("cameras")
    img_path, img_reader = pick("images")
    cams = cam_reader(cam_path)
    metas = sorted(img_reader(img_path), key=lambda m: m["name"])

    try:
        pts_path, pts_reader = pick("points3D")
        xyz, rgb, err = pts_reader(pts_path)
    except FileNotFoundError:
        xyz = np.zeros((0, 3))
        rgb = np.zeros((0, 3), np.uint8)
        err = np.zeros((0,))

    if images_dir is None:
        images_dir = os.path.normpath(
            os.path.join(sparse_dir, os.pardir, os.pardir, "images"))

    bundles, images = [], []
    for m in metas:
        cam = cams[m["camera_id"]]
        img = None
        if load_images and m["name"]:
            p = os.path.join(images_dir, m["name"])
            if os.path.exists(p):
                img = load_png(p)[..., :3]
        if undistort and img is not None and _needs_undistort(cam):
            img = undistort_image(img, cam)
            cam = undistorted_camera(cam)
        bundles.append(bundle_from_colmap_pose(m["qvec"], m["tvec"], cam))
        images.append(img)

    points = {"xyz": xyz.astype(np.float32),
              "rgb": rgb.astype(np.float32),
              "error": err.astype(np.float32)}
    return bundles, images, points


def init_params_from_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    opacity: float = 0.1,
    max_points: Optional[int] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Sparse SfM points -> initial splat parameters (3DGS sec. 4 init):
    isotropic scales from mean distance to the 3 nearest neighbors,
    identity rotations, constant ``opacity``, colors from point RGB."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
    if max_points and len(xyz) > max_points:
        idx = np.random.default_rng(seed).choice(
            len(xyz), max_points, replace=False)
        xyz, rgb = xyz[idx], rgb[idx]
    n = len(xyz)
    if n == 0:
        raise ValueError("empty point cloud")

    from scipy.spatial import cKDTree

    k = min(4, n)                       # self + 3 neighbors
    d, _ = cKDTree(xyz).query(xyz, k=k)
    if k > 1:
        mean_d = d[:, 1:].mean(axis=1)
    else:
        mean_d = np.full(n, 0.01, np.float32)
    mean_d = np.maximum(mean_d, 1e-7).astype(np.float32)

    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return {
        "means": xyz,
        "scales": np.repeat(mean_d[:, None], 3, axis=1),
        "quats": quats,
        "opacities": np.full(n, opacity, np.float32),
        "colors": rgb,                   # already 0..255 like PLY DC colors
    }


# --- writers (tests / export) ------------------------------------------------

def write_cameras_bin(path: str, cams: Dict[int, Dict]) -> None:
    name_to_id = {v[0]: k for k, v in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam_id, c in cams.items():
            model_id = name_to_id[c["model"]]
            f.write(struct.pack("<iiQQ", cam_id, model_id,
                                c["width"], c["height"]))
            f.write(struct.pack("<" + "d" * len(c["params"]),
                                *[float(p) for p in c["params"]]))


def write_images_bin(path: str, images: List[Dict]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for m in images:
            f.write(struct.pack("<idddddddi", m["image_id"],
                                *[float(v) for v in m["qvec"]],
                                *[float(v) for v in m["tvec"]],
                                m["camera_id"]))
            f.write(m["name"].encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))            # no 2D points


def write_points3d_bin(path: str, xyz, rgb, err=None) -> None:
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    rgb = np.asarray(rgb, np.uint8).reshape(-1, 3)
    err = np.zeros(len(xyz)) if err is None else np.asarray(err, np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i],
                                *[int(v) for v in rgb[i]], float(err[i])))
            f.write(struct.pack("<Q", 0))            # empty track
