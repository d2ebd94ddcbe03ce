"""Binary 3DGS PLY loading/saving.

Reads the standard 62-float-per-vertex 3D Gaussian Splatting layout
(x y z, nx ny nz, f_dc_0..2, f_rest_0..44, opacity, scale_0..2, rot_0..3)
that the reference parses at ``src/Splats.cpp:174-344``. Unlike the C++
loader, which hard-codes the layout and discards normals and the 45 f_rest
SH coefficients, this parser reads the header property list (like the
reference's more complete Python tooling, ``tests/plyFileGenerator.py:106-152``)
and keeps the full SH block for future view-dependent colour.

Activation transforms at load (ref ``src/Splats.cpp:275-331``):
colour = (0.5 + SH_C0 * f_dc) * 255, opacity = sigmoid(opacity),
scale = exp(scale), quaternion normalised (stored w, x, y, z).

``load_splats`` reads through the native C++ loader (``io/native.py``,
binding the repository's ``csrc/ply_loader.cpp``) where it builds and the
file has the standard layout; this numpy parser reads every other layout
and is the fixture oracle the native loader is tested against.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import Dict, List, Optional, Tuple

import numpy as np

# From graphdeco-inria/diff-gaussian-rasterization, cited by the reference at
# src/Splats.cpp:274-275 (defined here so this module needs no ops import).
SH_C0 = 0.28209479177387814

_PLY_DTYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
    "short": ("<i2", 2), "ushort": ("<u2", 2),
    "char": ("<i1", 1), "uchar": ("<u1", 1), "int8": ("<i1", 1), "uint8": ("<u1", 1),
}


@dataclasses.dataclass
class PlyData:
    """Raw (pre-activation) 3DGS parameters, as stored on disk."""

    means: np.ndarray        # (N, 3) float32
    normals: np.ndarray      # (N, 3) float32 (read and kept; unused by render)
    f_dc: np.ndarray         # (N, 3) float32
    f_rest: np.ndarray       # (N, K) float32, K = 45 for SH degree 3
    opacity_raw: np.ndarray  # (N,)  float32 (logit)
    scale_raw: np.ndarray    # (N, 3) float32 (log)
    rot_raw: np.ndarray      # (N, 4) float32 (unnormalised wxyz)

    def __len__(self) -> int:
        return self.means.shape[0]


def _parse_header(f) -> Tuple[int, List[Tuple[str, str]], int]:
    """Parse a binary_little_endian PLY header.

    Returns (num_vertices, [(prop_name, numpy_dtype)], header_end_offset).
    """
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    num = None
    props: List[Tuple[str, str]] = []
    fmt = None
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.strip().decode("ascii", "replace").split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                num = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in 3DGS PLY")
            dt = _PLY_DTYPES.get(tokens[1])
            if dt is None:
                raise ValueError(f"unsupported PLY property type {tokens[1]}")
            props.append((tokens[2], dt[0]))
        elif tokens[0] == "end_header":
            break
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt!r} (need binary_little_endian)")
    if num is None:
        raise ValueError("PLY has no vertex element")
    return num, props, f.tell()


def load_ply(path: str) -> PlyData:
    """Load raw 3DGS parameters from a binary PLY file."""
    with open(path, "rb") as f:
        num, props, offset = _parse_header(f)
        dtype = np.dtype([(name, dt) for name, dt in props])
        raw = np.fromfile(f, dtype=dtype, count=num)
    if raw.shape[0] != num:
        raise ValueError(f"expected {num} vertices, file held {raw.shape[0]}")

    names = {name for name, _ in props}

    def col(name: str, required: bool = True) -> Optional[np.ndarray]:
        if name not in names:
            if required:
                raise ValueError(f"PLY missing property {name}")
            return None
        return np.asarray(raw[name], dtype=np.float32)

    def stack(prefix_names: List[str]) -> np.ndarray:
        return np.stack([col(n) for n in prefix_names], axis=1)

    means = stack(["x", "y", "z"])
    if "nx" in names:
        normals = stack(["nx", "ny", "nz"])
    else:
        normals = np.zeros_like(means)
    f_dc = stack(["f_dc_0", "f_dc_1", "f_dc_2"])
    rest_names = sorted(
        (n for n in names if n.startswith("f_rest_")), key=lambda n: int(n.split("_")[-1])
    )
    if rest_names:
        f_rest = np.stack([col(n) for n in rest_names], axis=1)
    else:
        f_rest = np.zeros((means.shape[0], 0), dtype=np.float32)
    opacity = col("opacity")
    scale = stack(["scale_0", "scale_1", "scale_2"])
    rot = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    return PlyData(means, normals, f_dc, f_rest, opacity, scale, rot)


def activate(ply: PlyData, color_scale: float = 255.0) -> Dict[str, np.ndarray]:
    """Apply the reference's load-time activations (``src/Splats.cpp:275-331``)."""
    color = (0.5 + SH_C0 * ply.f_dc) * color_scale
    opacity = 1.0 / (1.0 + np.exp(-ply.opacity_raw))
    scale = np.exp(ply.scale_raw)
    norm = np.sqrt(np.sum(ply.rot_raw.astype(np.float64) ** 2, axis=1, keepdims=True))
    rot = (ply.rot_raw / norm).astype(np.float32)
    return {
        "means": ply.means.astype(np.float32),
        "colors": color.astype(np.float32),
        "opacities": opacity.astype(np.float32),
        "scales": scale.astype(np.float32),
        "quats": rot,
        "sh_rest": ply.f_rest.astype(np.float32),
    }


def load_splats(path: str, color_scale: float = 255.0) -> Dict[str, np.ndarray]:
    """Load + activate in one step. Tries the native C++ loader first."""
    from openglgaussiansplattingrenderer_tpu_torch.io import native

    out = native.load_splats(path, color_scale)
    if out is not None:
        return out
    return activate(load_ply(path), color_scale)


def save_ply(path: str, means: np.ndarray, quats: np.ndarray, scales: np.ndarray,
             opacities: np.ndarray, colors: np.ndarray,
             sh_rest: Optional[np.ndarray] = None,
             color_scale: float = 255.0, colors_are_dc: bool = False) -> None:
    """Write a 62-float 3DGS PLY, inverting the activations.

    Mirrors ``tests/plyFileGenerator.py:155-249``: opacity stored as logit,
    scales as log, colours converted back to f_dc unless ``colors_are_dc``.
    """
    means = np.asarray(means, dtype=np.float32)
    n = means.shape[0]
    quats = np.asarray(quats, dtype=np.float32).reshape(n, 4)
    scales = np.asarray(scales, dtype=np.float32).reshape(n, 3)
    opacities = np.asarray(opacities, dtype=np.float32).reshape(n)
    colors = np.asarray(colors, dtype=np.float32).reshape(n, 3)
    if sh_rest is None:
        sh_rest = np.zeros((n, 45), dtype=np.float32)
    sh_rest = np.asarray(sh_rest, dtype=np.float32).reshape(n, -1)
    n_rest = sh_rest.shape[1]

    if colors_are_dc:
        f_dc = colors
    else:
        f_dc = (colors / color_scale - 0.5) / SH_C0
    op = np.clip(opacities, 1e-7, 1.0 - 1e-7)
    opacity_raw = np.log(op / (1.0 - op)).astype(np.float32)
    scale_raw = np.log(np.maximum(scales, 1e-30)).astype(np.float32)

    header_props = (
        ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    )
    header = _io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n")
    for p in header_props:
        header.write(f"property float {p}\n")
    header.write("end_header\n")

    body = np.concatenate(
        [means, np.zeros((n, 3), dtype=np.float32), f_dc.astype(np.float32),
         sh_rest, opacity_raw[:, None], scale_raw, quats],
        axis=1,
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(body.tobytes())


def single_splat_scene() -> Dict[str, np.ndarray]:
    """The reference's checked-in single-Gaussian fixture ``testSingleItem.ply``.

    One white anisotropic Gaussian at the origin: f_dc (1,1,1), opacity 0.9,
    scale (1.0, 0.5, 0.5), quaternion (0, 0, 0, 1) wxyz (values read from the
    file at the reference repo root; see tests/test_ply.py).
    """
    return {
        "means": np.zeros((1, 3), dtype=np.float32),
        "quats": np.array([[0.0, 0.0, 0.0, 1.0]], dtype=np.float32),
        "scales": np.array([[1.0, 0.5, 0.5]], dtype=np.float32),
        "opacities": np.array([0.9], dtype=np.float32),
        "colors": (0.5 + SH_C0 * np.ones((1, 3), dtype=np.float32)) * 255.0,
        "sh_rest": np.zeros((1, 45), dtype=np.float32),
    }


def red_splat_scene() -> Dict[str, np.ndarray]:
    """The analytic scene built by ``tests/plyFileGenerator.py:251-265``:
    one red anisotropic Gaussian, quat (0.6502878, 0, 0, -0.7596879) wxyz,
    scale (0.5, 0.1, 0.1), opacity 0.9."""
    q = np.array([0.6502878, 0.0, 0.0, -0.7596879], dtype=np.float32)
    return {
        "means": np.zeros((1, 3), dtype=np.float32),
        "quats": (q / np.linalg.norm(q))[None, :],
        "scales": np.array([[0.5, 0.1, 0.1]], dtype=np.float32),
        "opacities": np.array([0.9], dtype=np.float32),
        "colors": (0.5 + SH_C0 * np.array([[1.0, 0.0, 0.0]], dtype=np.float32)) * 255.0,
        "sh_rest": np.zeros((1, 45), dtype=np.float32),
    }


def make_synthetic_scene(num_splats: int, seed: int = 0,
                         extent: float = 3.0, color_scale: float = 255.0,
                         log_scale_range: Tuple[float, float] = (-4.5, -2.0)
                         ) -> Dict[str, np.ndarray]:
    """Random synthetic scene generator for tests and benchmarks.

    Analogue of the grid generators in ``tests/plyFileGenerator.py``.
    """
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, size=(num_splats, 3)).astype(np.float32)
    quats = rng.normal(size=(num_splats, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    lo, hi = log_scale_range
    scales = np.exp(rng.uniform(lo, hi, size=(num_splats, 3))).astype(np.float32)
    opacities = (1.0 / (1.0 + np.exp(-rng.normal(0.0, 1.5, size=num_splats)))).astype(np.float32)
    f_dc = rng.uniform(-1.0, 1.0, size=(num_splats, 3)).astype(np.float32)
    colors = ((0.5 + SH_C0 * f_dc) * color_scale).astype(np.float32)
    return {
        "means": means,
        "quats": quats,
        "scales": scales,
        "opacities": opacities,
        "colors": colors,
        "sh_rest": np.zeros((num_splats, 45), dtype=np.float32),
    }


def make_clustered_scene(num_splats: int, seed: int = 0,
                         extent: float = 3.0, color_scale: float = 255.0,
                         num_clusters: int = 64,
                         cluster_sigma_range: Tuple[float, float] = (0.02, 0.6),
                         log_scale_mu: float = -4.8,
                         log_scale_sigma: float = 0.7,
                         background_frac: float = 0.15,
                         ) -> Dict[str, np.ndarray]:
    """Heavy-tailed clustered scene generator -- real-capture statistics.

    ``make_synthetic_scene``'s uniform-random cloud produces near-uniform
    tile occupancy; real SfM captures (e.g. the reference's bike-big.ply,
    the reference repo's ``tests/plyParseTests.cpp:69``) are heavily skewed:
    splats clump on surfaces and textured regions, tile bin counts are
    long-tailed, and saturation/early-exit behaviour differs from the
    uniform case. This generator models that with a Gaussian-mixture
    layout:

    - ``num_clusters`` cluster centers, uniform in the box; per-cluster
      population follows a Zipf-like power law (a few clusters dominate,
      like dominant foreground surfaces);
    - per-cluster isotropic sigma log-uniform in ``cluster_sigma_range``
      (tight detail clumps through broad structure);
    - splat log-scales are normal (``log_scale_mu``, ``log_scale_sigma``)
      -- a lognormal size distribution, matching the long right tail
      real captures show -- and correlated with their cluster's sigma
      (big structures carry big splats);
    - ``background_frac`` of splats are a uniform dust cloud.
    """
    rng = np.random.default_rng(seed)
    n_bg = int(num_splats * background_frac)
    n_cl = num_splats - n_bg

    centers = rng.uniform(-extent, extent, size=(num_clusters, 3))
    csig = np.exp(rng.uniform(np.log(cluster_sigma_range[0]),
                              np.log(cluster_sigma_range[1]),
                              size=num_clusters))
    # Zipf-ish cluster populations: weight_k ~ 1 / rank
    w = 1.0 / np.arange(1, num_clusters + 1)
    w /= w.sum()
    assign = rng.choice(num_clusters, size=n_cl, p=w)
    means_cl = centers[assign] + rng.normal(size=(n_cl, 3)) * csig[assign][:, None]
    means_bg = rng.uniform(-extent, extent, size=(n_bg, 3))
    means = np.concatenate([means_cl, means_bg]).astype(np.float32)

    quats = rng.normal(size=(num_splats, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)

    # splat size rides the parent structure scale (background uses the mean)
    sig_of = np.concatenate([csig[assign], np.full(n_bg, csig.mean())])
    log_s = (log_scale_mu + 0.5 * np.log(sig_of / csig.mean())
             + rng.normal(0.0, log_scale_sigma, size=num_splats))
    # anisotropy: per-axis jitter around the splat's base scale
    scales = np.exp(log_s[:, None]
                    + rng.normal(0.0, 0.4, size=(num_splats, 3))
                    ).astype(np.float32)

    opacities = (1.0 / (1.0 + np.exp(-rng.normal(0.0, 1.5, size=num_splats)))
                 ).astype(np.float32)
    f_dc = rng.uniform(-1.0, 1.0, size=(num_splats, 3)).astype(np.float32)
    colors = ((0.5 + SH_C0 * f_dc) * color_scale).astype(np.float32)
    return {
        "means": means,
        "quats": quats,
        "scales": scales.astype(np.float32),
        "opacities": opacities,
        "colors": colors,
        "sh_rest": np.zeros((num_splats, 45), dtype=np.float32),
    }
