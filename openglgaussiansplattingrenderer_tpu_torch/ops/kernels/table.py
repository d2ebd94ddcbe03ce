"""The splat table: preprocess, covariance, SH colours and tile rects of
every splat, forward and backward.

The port's own kernels, with no Pallas counterpart: the JAX package
computes this stage inside ``jax.jit``, where XLA fuses
``ops/projection.preprocess``, ``build_covariance``, ``effective_colors``
and the table rows of ``ops/fastpath.py`` into a few kernels. Here it is
``csrc/table.cu``: ``gs_splat_table``, one thread a splat, writes the
table the expansion reads ((9, N) fields mx, my, A, B, C, opacity, r, g,
b, the tile rect and counts, the depth) and what ``prep`` hands on;
``gs_splat_table_bwd`` is its analytic backward, one thread a splat, fed
the (9, N) field cotangents the segment sum makes. ``SplatTable``, a
``torch.autograd.Function``, joins them and saves the inputs, not the
intermediates: the backward recomputes the projection. Where the record
sort stage asks for it (``pairs``), the forward also stores the fields in
the stage's pair layout (``splat_pairs_plain``).

The plain versions are ``splat_table_plain`` (``projection.preprocess``
and the field stack in torch, whose arithmetic the kernel repeats operation
for operation) and ``splat_table_bwd_plain`` (the kernel's analytic
backward in torch). On CPU tensors ``SplatTable`` runs the two of them; on
CUDA tensors the kernels, or it raises.

Derivatives follow torch autograd of the plain forward: ``maximum`` and
``minimum`` split a tie's gradient in halves, ``clamp_min`` passes it where
x >= the bound, ``torch.where`` gives the branch taken; the radius (a
ceil), the tight rect's detached half-extents, counts and depth get none;
a splat whose nine field cotangents (and mean2d cotangents) are all zero
gets zero gradients, where autograd's 0 * inf would give NaN. The gradient
of ``shift2d`` is rows 0-1 of the cotangent.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import projection
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import padded_dims
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import (
    SH_C0,
    SH_C1,
    SH_C2,
    SH_C3,
    build_covariance,
    camera_center_from_view,
    covariance_quadratic_form,
    quat_to_rotmat,
)
from openglgaussiansplattingrenderer_tpu_torch.utils.timing import span

NUM_FIELDS = 9
# (N + 1)-float arrays of the pair layout: four of field pairs, field 8's
PAIR_LAYOUT_ROWS = 9
# the inputs of the table, in SplatTable's order
INPUTS = ("means", "cov6", "scales", "quats", "opacities", "colors", "sh_rest", "shift2d")
# packed covariance entries (xx, xy, xz, yy, yz, zz) by index pair
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


class TableArgs(ctypes.Structure):
    """The frame's scalars as ``csrc/table.cu`` reads them."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "width", "height", "focal_x", "focal_y", "tan_fovx", "tan_fovy",
        "neg_fov_margin", "w_eps", "dilation", "eig_floor", "radius_sigma",
        "alpha_min", "inv_tile_w", "inv_tile_h", "inv_alpha_min",
        "inv_color_scale", "color_scale")] + [
        (name, ctypes.c_int) for name in (
            "gx", "gy", "antialiased", "tight_rect", "sh_degree", "sh_row")]


@functools.lru_cache(maxsize=1)
def _library():
    """(the kernel library, the most sh_rest floats a splat it stages), once
    ``TableArgs`` is checked against the kernel's layout."""
    lib = build.load_library()
    if lib.gs_table_args_size() != ctypes.sizeof(TableArgs):
        raise RuntimeError(f"table: the kernel's TableArgs has "
                           f"{lib.gs_table_args_size()} bytes, TableArgs "
                           f"{ctypes.sizeof(TableArgs)}")
    return lib, lib.gs_table_sh_row_max()


def sh_coeffs_used(degree: int) -> int:
    """SH coefficients a channel that ``eval_sh`` reads at ``degree``."""
    return (min(degree, 3) + 1) ** 2 - 1


def table_args(spec, sh_row: int) -> TableArgs:
    """The kernel's scalars of a frame ``spec`` = (focal_x, focal_y,
    tan_fovx, tan_fovy, width, height, cfg); each is rounded to float32 as
    torch rounds a Python scalar. Where the plain version divides a tensor
    by a Python scalar, torch on the card multiplies by the reciprocal
    taken in double and rounded to float32 (on the CPU it divides): the
    kernel takes those reciprocals."""
    focal_x, focal_y, tan_fovx, tan_fovy, width, height, cfg = spec
    if cfg.int_tile_size:     # the tile rect's divisors, as preprocess takes them
        tile_w, tile_h = cfg.tile_size(width, height)
    else:
        wp, hp = padded_dims(width, height, cfg)
        tile_w, tile_h = wp / cfg.grid_x, hp / cfg.grid_y
    return TableArgs(
        width=float(width), height=float(height), focal_x=float(focal_x),
        focal_y=float(focal_y), tan_fovx=float(tan_fovx), tan_fovy=float(tan_fovy),
        neg_fov_margin=-cfg.fov_margin, w_eps=cfg.w_eps, dilation=cfg.dilation,
        eig_floor=cfg.eig_floor, radius_sigma=cfg.radius_sigma,
        alpha_min=cfg.alpha_min, inv_tile_w=1.0 / tile_w, inv_tile_h=1.0 / tile_h,
        inv_alpha_min=1.0 / cfg.alpha_min, inv_color_scale=1.0 / cfg.color_scale,
        color_scale=cfg.color_scale, gx=cfg.grid_x, gy=cfg.grid_y,
        antialiased=int(cfg.antialiased), tight_rect=int(cfg.tight_rect),
        sh_degree=cfg.sh_degree if sh_row else 0, sh_row=sh_row)


def _params(inputs: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in inputs.items() if v is not None}


def splat_table_plain(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y,
                      tan_fovx, tan_fovy, width: int, height: int, cfg: RenderConfig):
    """The plain PyTorch version: ``projection.preprocess`` and the
    per-splat inputs of the expansion. Returns ((fields (9, N), tile_min
    (N, 2), tile_ext (N, 2), depth (N,)), prep): the record fields mx, my,
    A, B, C, op, r, g, b, the splat's tile rect, and its depth (0 where
    invalid or non-finite)."""
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], view, vp,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    from openglgaussiansplattingrenderer_tpu_torch.render import effective_colors

    colors = effective_colors(params, view, cfg)
    mean2d = prep["mean2d"]
    if "shift2d" in params:
        mean2d = mean2d + params["shift2d"]
    fields = torch.stack([
        mean2d[:, 0], mean2d[:, 1],
        prep["conic"][:, 0], prep["conic"][:, 1], prep["conic"][:, 2],
        prep["opacity"], colors[:, 0], colors[:, 1], colors[:, 2]])
    zero = torch.zeros((), dtype=torch.float32, device=mean2d.device)
    depth = torch.where(prep["valid"], prep["depth"], zero)
    depth = torch.where(torch.isfinite(depth), depth, zero).detach()
    return (fields.contiguous(), prep["tile_min"].contiguous(),
            prep["tile_ext"].contiguous(), depth.contiguous()), prep


def _sh_basis(degree: int, d: torch.Tensor):
    """eval_sh's basis at unit directions d (N, 3): (N, 15) factors of the
    15 coefficients and their gradients (N, 15, 3); zero past ``degree``."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    zero = torch.zeros_like(x)
    b = [zero] * 15
    gb = [(zero, zero, zero)] * 15
    if degree >= 1:
        c1 = torch.full_like(x, SH_C1)
        b[0:3] = [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        gb[0:3] = [(zero, -c1, zero), (zero, zero, c1), (-c1, zero, zero)]
    if degree >= 2:
        c = SH_C2
        b[3:8] = [c[0] * x * y, c[1] * y * z, c[2] * (2.0 * zz - xx - yy),
                  c[3] * x * z, c[4] * (xx - yy)]
        gb[3:8] = [(c[0] * y, c[0] * x, zero), (zero, c[1] * z, c[1] * y),
                   (-2.0 * c[2] * x, -2.0 * c[2] * y, 4.0 * c[2] * z),
                   (c[3] * z, zero, c[3] * x), (2.0 * c[4] * x, -2.0 * c[4] * y, zero)]
    if degree >= 3:
        c = SH_C3
        b[8:15] = [c[0] * y * (3.0 * xx - yy), c[1] * x * y * z,
                   c[2] * y * (4.0 * zz - xx - yy),
                   c[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                   c[4] * x * (4.0 * zz - xx - yy), c[5] * z * (xx - yy),
                   c[6] * x * (xx - 3.0 * yy)]
        gb[8:15] = [
            (c[0] * 6.0 * x * y, c[0] * (3.0 * xx - 3.0 * yy), zero),
            (c[1] * y * z, c[1] * x * z, c[1] * x * y),
            (c[2] * -2.0 * x * y, c[2] * (4.0 * zz - xx - 3.0 * yy), c[2] * 8.0 * y * z),
            (c[3] * -6.0 * x * z, c[3] * -6.0 * y * z, c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
            (c[4] * (4.0 * zz - 3.0 * xx - yy), c[4] * -2.0 * x * y, c[4] * 8.0 * x * z),
            (c[5] * 2.0 * x * z, c[5] * -2.0 * y * z, c[5] * (xx - yy)),
            (c[6] * (3.0 * xx - 3.0 * yy), c[6] * -6.0 * x * y, zero)]
    return torch.stack(b, dim=1), torch.stack([torch.stack(v, dim=1) for v in gb], dim=1)


def splat_table_bwd_plain(inputs: Dict[str, Optional[torch.Tensor]], view, vp, spec,
                          g_fields: torch.Tensor,
                          g_mean2d: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the backward: the gradients of the
    table's inputs (means, cov6 or scales and quats, opacities, colors,
    sh_rest where given) from the field cotangents ``g_fields`` (9, N) and
    the unshifted mean2d's ``g_mean2d`` (N, 2) or None. ``inputs`` holds
    the forward's tensors by the names of ``INPUTS``; ``spec`` is
    (focal_x, focal_y, tan_fovx, tan_fovy, width, height, cfg). The
    formulas are the kernel's, in float32: it recomputes the forward's
    intermediates and applies the chain rule by hand."""
    focal_x, focal_y, tan_fovx, tan_fovy, width, height, cfg = spec
    f32 = torch.float32
    dev = g_fields.device
    zero = torch.zeros((), dtype=f32, device=dev)

    def sc(v):
        return torch.as_tensor(v, dtype=f32, device=dev)

    def where(cond, a, b=zero):
        return torch.where(cond, a, b)

    means = inputs["means"].to(f32)
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    V, P = view.to(f32), vp.to(f32)
    cov6 = inputs.get("cov6")
    if cov6 is None:
        s, q = inputs["scales"].to(f32), inputs["quats"].to(f32)
        R = quat_to_rotmat(q)
        M = R * s[:, None, :]
        cov = torch.stack([(M[:, i] * M[:, j]).sum(dim=1) for i, j in _PAIRS], dim=1)
    else:
        cov = cov6.to(f32)

    # the forward's intermediates (projection.preprocess)
    p = [mx * P[j, 0] + my * P[j, 1] + mz * P[j, 2] + P[j, 3] for j in range(4)]
    t = [mx * V[j, 0] + my * V[j, 1] + mz * V[j, 2] + V[j, 3] for j in range(3)]
    w = torch.clamp_min(p[3], cfg.w_eps)
    ndc0, ndc1 = p[0] / w, p[1] / w
    sx = (ndc0 + 1.0) * 0.5 * width
    sy = (ndc1 + 1.0) * 0.5 * height
    tz = t[2]
    limx = -cfg.fov_margin * sc(tan_fovx)
    limy = -cfg.fov_margin * sc(tan_fovy)
    txtz, tytz = t[0] / tz, t[1] / tz
    mxc, myc = torch.maximum(-limx, txtz), torch.maximum(-limy, tytz)
    cx, cy = torch.minimum(limx, mxc), torch.minimum(limy, myc)
    tx, ty = cx * tz, cy * tz
    it = 1.0 / tz
    fx, fy = sc(focal_x), sc(focal_y)
    u0 = (fx * it)[:, None] * V[0, :3][None, :] - (fx * tx * it * it)[:, None] * V[2, :3][None, :]
    u1 = (fy * it)[:, None] * V[1, :3][None, :] - (fy * ty * it * it)[:, None] * V[2, :3][None, :]
    a2d = covariance_quadratic_form(cov, u0, u0) + cfg.dilation
    b2d = covariance_quadratic_form(cov, u0, u1)
    c2d = covariance_quadratic_form(cov, u1, u1) + cfg.dilation
    det = a2d * c2d - b2d * b2d
    culled = (ndc0.abs() > 1.0) | (ndc1.abs() > 1.0)
    degenerate = ((det == 0.0) | ~torch.isfinite(det) | ~torch.isfinite(sx)
                  | ~torch.isfinite(sy))
    valid = ~culled & ~degenerate
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)

    g = g_fields.to(f32)
    live = (g != 0.0).any(dim=0)
    g_sx, g_sy = g[0], g[1]
    if g_mean2d is not None:
        gm = g_mean2d.to(f32)
        live = live | (gm != 0.0).any(dim=1)
        g_sx, g_sy = g_sx + gm[:, 0], g_sy + gm[:, 1]

    # opacity: op = op0 * where(valid, sqrt(clamp(det_nodil) / clamp(det)), 1)
    g_a, g_b, g_c, g_det = zero, zero, zero, zero
    g_op0 = g[5]
    if cfg.antialiased:
        am, cm = a2d - cfg.dilation, c2d - cfg.dilation
        dn = am * cm - b2d * b2d
        num, den = torch.clamp_min(dn, 1e-30), torch.clamp_min(det, 1e-30)
        comp = torch.sqrt(num / den)
        g_op0 = where(valid, g[5] * comp, g[5])
        g_ratio = where(valid, g[5] * inputs["opacities"].to(f32) / (2.0 * comp))
        g_num = where(dn >= 1e-30, g_ratio / den)
        g_a, g_c, g_b = g_num * cm, g_num * am, -2.0 * b2d * g_num
        g_det = where(det >= 1e-30, -g_ratio * num / (den * den))
    # conic = (c2d, -b2d, a2d) * inv, inv = 1 / where(det == 0, 1, det)
    g_c = g_c + g[2] * inv
    g_b = g_b - g[3] * inv
    g_a = g_a + g[4] * inv
    g_inv = g[2] * c2d - g[3] * b2d + g[4] * a2d
    g_det = g_det - where(det == 0.0, zero, g_inv * inv * inv)
    g_a, g_c, g_b = g_a + g_det * c2d, g_c + g_det * a2d, g_b - 2.0 * g_det * b2d

    # the quadratic forms u' Sigma v
    rows = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    su0 = torch.stack([sum(cov[:, r] * u0[:, j] for j, r in enumerate(rw)) for rw in rows], 1)
    su1 = torch.stack([sum(cov[:, r] * u1[:, j] for j, r in enumerate(rw)) for rw in rows], 1)
    gu0 = 2.0 * g_a[:, None] * su0 + g_b[:, None] * su1
    gu1 = 2.0 * g_c[:, None] * su1 + g_b[:, None] * su0
    gcov = []
    for i, j in _PAIRS:
        if i == j:
            gcov.append(g_a * u0[:, i] * u0[:, i] + g_b * u0[:, i] * u1[:, i]
                        + g_c * u1[:, i] * u1[:, i])
        else:
            gcov.append(2.0 * g_a * u0[:, i] * u0[:, j]
                        + g_b * (u0[:, i] * u1[:, j] + u1[:, i] * u0[:, j])
                        + 2.0 * g_c * u1[:, i] * u1[:, j])
    gcov = torch.stack(gcov, dim=1)

    # u0 = al0 V0 - be0 V2 with al0 = fx it, be0 = fx tx it it; u1 alike
    g_al0 = (gu0 * V[0, :3]).sum(dim=1)
    g_be0 = -(gu0 * V[2, :3]).sum(dim=1)
    g_al1 = (gu1 * V[1, :3]).sum(dim=1)
    g_be1 = -(gu1 * V[2, :3]).sum(dim=1)
    g_it = (g_al0 * fx + g_al1 * fy + 2.0 * g_be0 * fx * tx * it
            + 2.0 * g_be1 * fy * ty * it)
    g_tx, g_ty = g_be0 * fx * it * it, g_be1 * fy * it * it
    # tx = minimum(lim, maximum(-lim, t0 / tz)) * tz; ties split in halves
    half, one = torch.full_like(zero, 0.5), torch.ones_like(zero)
    sel_x = where(limx < mxc, zero, where(limx == mxc, half, one))
    sel_y = where(limy < myc, zero, where(limy == myc, half, one))
    sel_x = sel_x * where(-limx > txtz, zero, where(-limx == txtz, half, one))
    sel_y = sel_y * where(-limy > tytz, zero, where(-limy == tytz, half, one))
    g_txtz, g_tytz = g_tx * tz * sel_x, g_ty * tz * sel_y
    g_tz = (g_tx * cx + g_ty * cy
            - (g_txtz * t[0] / (tz * tz) + g_tytz * t[1] / (tz * tz)) - g_it * it * it)
    g_t0, g_t1 = g_txtz / tz, g_tytz / tz

    # the screen position: s = (p / w + 1) * 0.5 * size, w = clamp_min(p3, w_eps)
    g_n0, g_n1 = g_sx * width * 0.5, g_sy * height * 0.5
    g_p0, g_p1 = g_n0 / w, g_n1 / w
    g_p3 = where(p[3] >= cfg.w_eps, -(g_n0 * p[0] + g_n1 * p[1]) / (w * w))
    g_means = torch.stack([
        g_t0 * V[0, k] + g_t1 * V[1, k] + g_tz * V[2, k] + g_p0 * P[0, k]
        + g_p1 * P[1, k] + g_p3 * P[3, k] for k in range(3)], dim=1)

    grads = {}
    g_col = g[6:9].t()
    sh_rest = inputs.get("sh_rest")
    if sh_rest is not None and cfg.sh_degree > 0:
        n = means.shape[0]
        k_all = sh_rest.shape[1] // 3
        used = sh_coeffs_used(cfg.sh_degree)
        dv = means - camera_center_from_view(view).to(f32)[None, :]
        nrm = torch.linalg.vector_norm(dv, dim=1)
        nc = torch.clamp_min(nrm, 1e-12)
        b, gb = _sh_basis(cfg.sh_degree, dv / nc[:, None])
        gc = g_col * cfg.color_scale                               # (N, 3)
        sh3 = sh_rest.to(f32).reshape(n, 3, k_all)[:, :, :used]
        g_sh = torch.zeros((n, 3, k_all), dtype=f32, device=dev)
        g_sh[:, :, :used] = gc[:, :, None] * b[:, None, :used]
        gd = ((gc[:, :, None] * sh3).sum(dim=1)[:, :, None] * gb[:, :used]).sum(dim=1)
        g_n = where(nrm >= 1e-12, -(gd * dv).sum(dim=1) / (nc * nc))
        g_means = (g_means + gd / nc[:, None]
                   + where(nrm == 0.0, zero, g_n / nrm)[:, None] * dv)
        g_col = gc * SH_C0 / SH_C0 / cfg.color_scale
        grads["sh_rest"] = g_sh.reshape(n, 3 * k_all)

    grads.update(means=g_means, opacities=g_op0, colors=g_col)
    if cov6 is not None:
        grads["cov6"] = gcov
    else:
        # Sigma = M M^T, M = R diag(s)
        gM = torch.stack([
            2.0 * gcov[:, 0, None] * M[:, 0] + gcov[:, 1, None] * M[:, 1] + gcov[:, 2, None] * M[:, 2],
            gcov[:, 1, None] * M[:, 0] + 2.0 * gcov[:, 3, None] * M[:, 1] + gcov[:, 4, None] * M[:, 2],
            gcov[:, 2, None] * M[:, 0] + gcov[:, 4, None] * M[:, 1] + 2.0 * gcov[:, 5, None] * M[:, 2],
        ], dim=1)
        grads["scales"] = (gM * R).sum(dim=1)
        gR = gM * s[:, None, :]
        r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]

        def gr_(i, j):
            return gR[:, i, j]

        grads["quats"] = 2.0 * torch.stack([
            -z * gr_(0, 1) + y * gr_(0, 2) + z * gr_(1, 0) - x * gr_(1, 2)
            - y * gr_(2, 0) + x * gr_(2, 1),
            y * gr_(0, 1) + z * gr_(0, 2) + y * gr_(1, 0) - 2.0 * x * gr_(1, 1)
            - r * gr_(1, 2) + z * gr_(2, 0) + r * gr_(2, 1) - 2.0 * x * gr_(2, 2),
            -2.0 * y * gr_(0, 0) + x * gr_(0, 1) + r * gr_(0, 2) + x * gr_(1, 0)
            + z * gr_(1, 2) - r * gr_(2, 0) + z * gr_(2, 1) - 2.0 * y * gr_(2, 2),
            -2.0 * z * gr_(0, 0) - r * gr_(0, 1) + x * gr_(0, 2) + r * gr_(1, 0)
            - 2.0 * z * gr_(1, 1) + y * gr_(1, 2) + x * gr_(2, 0) + y * gr_(2, 1),
        ], dim=1)
    # a splat with no cotangent gets none, even where a partial is not finite
    return {k: where(live.reshape((-1,) + (1,) * (v.dim() - 1)), v).to(inputs[k].dtype)
            for k, v in grads.items()}


def _expect_inputs(name: str, inputs, view, vp) -> int:
    n = inputs["means"].shape[0]
    shapes = {"means": (n, 3), "cov6": (n, 6), "scales": (n, 3), "quats": (n, 4),
              "opacities": (n,), "colors": (n, 3), "sh_rest": (n, None),
              "shift2d": (n, 2)}
    for k, t in inputs.items():
        if t is not None:
            build.expect(f"{name} {k}", t, torch.float32, shapes[k])
    if inputs.get("cov6") is None and (inputs.get("scales") is None
                                       or inputs.get("quats") is None):
        raise ValueError(f"{name}: needs cov6, or scales and quats")
    for k, m in (("view", view), ("vp", vp)):
        build.expect(f"{name} {k}", m, torch.float32, (4, 4))
    return n


def _sh_row(name: str, sh_rest, cfg: RenderConfig, row_max: int) -> int:
    """Floats of sh_rest a splat the kernel reads (0 without SH colours)."""
    if sh_rest is None or cfg.sh_degree <= 0:
        return 0
    row = sh_rest.shape[1]
    if row % 3 or row > row_max or row // 3 < sh_coeffs_used(cfg.sh_degree):
        raise ValueError(f"{name}: sh_rest rows of {row} floats do not hold "
                         f"degree {cfg.sh_degree} (3 K floats, K >= "
                         f"{sh_coeffs_used(cfg.sh_degree)}, at most {row_max})")
    return row


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _centre(view, sh_row: int):
    """The camera centre as ``render.effective_colors`` computes it."""
    return camera_center_from_view(view).to(torch.float32).contiguous() if sh_row else None


def splat_pairs_plain(fields: torch.Tensor) -> torch.Tensor:
    """The record sort stage's pair layout of (9, N) ``fields`` in plain
    torch, what the forward kernel stores with ``pairs``: (9 (N + 1),) f32,
    the four (N + 1, 2) arrays of fields (0, 1) .. (6, 7), then field 8's
    (N + 1,) array; row N zero (``record_sort.record_sort_splats`` reads
    it)."""
    n = fields.shape[1]
    padded = torch.cat([fields, fields.new_zeros((NUM_FIELDS, 1))], 1)
    pairs = padded[:8].reshape(4, 2, n + 1).transpose(1, 2).reshape(-1)
    return torch.cat([pairs, padded[8]])


def splat_table_fwd_plain(inputs: Dict[str, Optional[torch.Tensor]], view, vp, spec,
                          pairs: bool = False):
    """``splat_table_plain`` with ``splat_table_fwd``'s inputs and outputs."""
    (fields, tile_min, tile_ext, depth), prep = splat_table_plain(
        _params(inputs), view, vp, *spec)
    mean2d = prep["mean2d"] if inputs.get("shift2d") is not None else None
    out = (fields, mean2d, tile_min, tile_ext, prep["counts"], depth, prep["depth"],
           prep["radius"], prep["valid"], prep["culled"])
    return out + (splat_pairs_plain(fields.detach()),) if pairs else out


def table_inputs(params: Dict[str, torch.Tensor], cfg: RenderConfig):
    """The table's inputs of a parameter dict, by the names of ``INPUTS``
    (None where absent), contiguous: cov6 where given, else scales and
    quats; sh_rest only where ``cfg.sh_degree`` > 0."""
    cov6 = params.get("cov6")
    given = dict(params, sh_rest=params.get("sh_rest") if cfg.sh_degree > 0 else None)
    if cov6 is not None:
        given.update(scales=None, quats=None)
    return {k: None if given.get(k) is None else given[k].contiguous() for k in INPUTS}


def splat_table_fwd(inputs: Dict[str, Optional[torch.Tensor]], view, vp, spec,
                    pairs: bool = False):
    """The forward alone (no autograd graph): the CUDA kernel for CUDA
    tensors, ``splat_table_plain`` for CPU tensors. Returns (fields (9, N),
    the unshifted mean2d (N, 2) where ``shift2d`` is given else None,
    tile_min, tile_ext, counts, depth, the raw depth, radius, valid,
    culled), and with ``pairs`` the fields in the record sort stage's pair
    layout (``splat_pairs_plain``), which the kernel stores
    beside them."""
    cfg = spec[-1]
    given = [t for t in inputs.values() if t is not None]
    if not build.on_cuda("splat_table", *given, view, vp, has_backward=True):
        return splat_table_fwd_plain(inputs, view, vp, spec, pairs)
    n = _expect_inputs("splat_table", inputs, view, vp)
    lib, row_max = _library()
    sh_row = _sh_row("splat_table", inputs.get("sh_rest"), cfg, row_max)
    dev = view.device
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    fields = torch.empty((NUM_FIELDS, n), **f32)
    tile_min, tile_ext = torch.empty((n, 2), **i32), torch.empty((n, 2), **i32)
    counts = torch.empty(n, **i32)
    depth, raw_depth, radius = (torch.empty(n, **f32) for _ in range(3))
    mean2d = torch.empty((n, 2), **f32) if inputs.get("shift2d") is not None else None
    valid, culled = (torch.empty(n, dtype=torch.bool, device=dev) for _ in range(2))
    out = (fields, mean2d, tile_min, tile_ext, counts, depth, raw_depth, radius, valid,
           culled)
    pair_rows = torch.empty(PAIR_LAYOUT_ROWS * (n + 1), **f32) if pairs else None
    if pairs:
        out += (pair_rows,)
    if n == 0:
        return out if pair_rows is None else out[:-1] + (pair_rows.zero_(),)
    centre = _centre(view, sh_row)
    args = table_args(spec, sh_row)
    build.check("splat_table", lib.gs_splat_table(
        *(_ptr(inputs.get(k)) for k in INPUTS), view.data_ptr(), vp.data_ptr(),
        _ptr(centre), ctypes.addressof(args), *(_ptr(t) for t in out[:1] + out[2:5]),
        depth.data_ptr(), raw_depth.data_ptr(), _ptr(mean2d), radius.data_ptr(),
        valid.data_ptr(), culled.data_ptr(), _ptr(pair_rows), n, build.stream_ptr()))
    splat_table.launches += 1
    return out


def splat_table_bwd(inputs: Dict[str, Optional[torch.Tensor]], view, vp, spec,
                    g_fields: torch.Tensor,
                    g_mean2d: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The gradients of the table's inputs from the field cotangents
    ``g_fields`` (9, N) and ``g_mean2d`` (N, 2) or None: the CUDA kernel for
    CUDA tensors, ``splat_table_bwd_plain`` (which says what it returns) for
    CPU tensors."""
    cfg = spec[-1]
    inputs = {k: v for k, v in inputs.items() if k != "shift2d"}
    given = [t for t in (*inputs.values(), g_mean2d) if t is not None]
    if not build.on_cuda("splat_table_bwd", *given, view, vp, g_fields):
        return splat_table_bwd_plain(inputs, view, vp, spec, g_fields, g_mean2d)
    n = _expect_inputs("splat_table_bwd", inputs, view, vp)
    build.expect("splat_table_bwd g_fields", g_fields, torch.float32, (NUM_FIELDS, n))
    if g_mean2d is not None:
        build.expect("splat_table_bwd g_mean2d", g_mean2d, torch.float32, (n, 2))
    lib, row_max = _library()
    sh_rest = inputs.get("sh_rest")
    sh_row = _sh_row("splat_table_bwd", sh_rest, cfg, row_max)
    grads = {k: torch.empty_like(inputs[k]) for k in
             ("means", "cov6", "scales", "quats", "opacities") if inputs.get(k) is not None}
    grads["colors"] = torch.empty_like(inputs["means"])
    if sh_row:
        grads["sh_rest"] = torch.empty_like(sh_rest)
    if n == 0:
        return grads
    centre = _centre(view, sh_row)
    args = table_args(spec, sh_row)
    build.check("splat_table_bwd", lib.gs_splat_table_bwd(
        *(_ptr(inputs.get(k)) for k in ("means", "cov6", "scales", "quats", "opacities")),
        _ptr(sh_rest if sh_row else None), view.data_ptr(), vp.data_ptr(), _ptr(centre),
        ctypes.addressof(args), g_fields.data_ptr(), _ptr(g_mean2d),
        *(_ptr(grads.get(k)) for k in
          ("means", "cov6", "scales", "quats", "opacities", "colors", "sh_rest")),
        n, build.stream_ptr()))
    splat_table_bwd.launches += 1
    return grads


class SplatTable(torch.autograd.Function):
    """``splat_table_fwd`` with ``splat_table_bwd`` as its gradient with
    respect to the float inputs, through the fields and the unshifted
    mean2d; the other outputs are not differentiable."""

    @staticmethod
    def forward(ctx, means, cov6, scales, quats, opacities, colors, sh_rest, shift2d,
                view, vp, spec, pairs):
        inputs = dict(zip(INPUTS, (means, cov6, scales, quats, opacities, colors,
                                   sh_rest, shift2d)))
        out = splat_table_fwd(inputs, view, vp, spec, pairs)
        ctx.spec = spec
        ctx.n = means.shape[0]
        ctx.save_for_backward(means, cov6, scales, quats, opacities, colors, sh_rest,
                              view, vp)
        ctx.mark_non_differentiable(*out[2:])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_fields, g_mean2d, *_):
        with span("gs.table.bwd"):
            if g_fields is None and g_mean2d is None:
                return (None,) * 12
            means, cov6, scales, quats, opacities, colors, sh_rest, view, vp = ctx.saved_tensors
            if g_fields is None:
                g_fields = torch.zeros((NUM_FIELDS, ctx.n), dtype=torch.float32,
                                       device=means.device)
            inputs = dict(zip(INPUTS[:7], (means, cov6, scales, quats, opacities, colors,
                                           sh_rest)))
            grads = splat_table_bwd(inputs, view, vp, ctx.spec, g_fields.contiguous(),
                                    None if g_mean2d is None else g_mean2d.contiguous())
            g_shift = g_fields[0:2].t().contiguous() if ctx.needs_input_grad[7] else None
            return (*(grads.get(k) for k in INPUTS[:7]), g_shift, None, None, None, None)


def splat_table(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y, tan_fovx,
                tan_fovy, width: int, height: int, cfg: RenderConfig, pairs: bool = False):
    """Preprocess and the per-splat inputs of the expansion, differentiable
    with respect to every float parameter. Returns ((fields (9, N),
    tile_min (N, 2), tile_ext (N, 2), depth (N,)), prep): the record fields
    mx, my, A, B, C, op, r, g, b (mx, my with ``shift2d`` added), the
    splat's tile rect, its depth (0 where invalid or non-finite), and
    ``projection.preprocess``'s keys (mean2d without the shift, conic,
    opacity, the raw depth, radius, tile_min, tile_ext, counts, valid,
    culled); with ``pairs`` also "pairs", the fields in the record sort
    stage's pair layout (no gradient), stored by the same launch.
    ``splat_table.launches`` counts forward kernel launches,
    ``splat_table_bwd.launches`` backward ones."""
    spec = (focal_x, focal_y, tan_fovx, tan_fovy, width, height, cfg)
    (fields, mean2d, tile_min, tile_ext, counts, depth, raw_depth, radius, valid,
     culled, *pair_rows) = SplatTable.apply(*table_inputs(params, cfg).values(),
                                            view.contiguous(), vp.contiguous(), spec, pairs)
    prep = {"mean2d": fields[0:2].t() if mean2d is None else mean2d,
            "conic": fields[2:5].t(), "opacity": fields[5], "depth": raw_depth,
            "radius": radius, "tile_min": tile_min, "tile_ext": tile_ext,
            "counts": counts, "valid": valid, "culled": culled}
    if pairs:
        prep["pairs"] = pair_rows[0]
    return (fields, tile_min, tile_ext, depth), prep


splat_table.launches = 0
splat_table_bwd.launches = 0
