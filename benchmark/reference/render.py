"""The plain reference renderer: a 3DGS frame and its gradient in torch.

What the benchmark holds the program's frames and steps against. It
imports nothing of the program: the formulas are the reference renderer's
(``shaders/preprocess.glsl``, ``shaders/draw.glsl``; the EWA projection of
Kerbl et al. 2023 with the reference's constants and quirks, the 0.3
dilation, the 3-sigma radius with the opacity-aware tight rectangle, the
1/255 alpha floor, the 0.99 alpha clamp and the 0.99 saturation break),
written once more in plain tensor operations:

- ``project``: covariance, EWA projection, SH colour, tile rectangles;
- ``bin_and_sort``: one record a (splat, tile) pair, stably sorted by
  (tile, depth) with two ``torch.sort`` calls;
- ``Compositor``: front-to-back blending tile by tile, in blocks of
  (tiles, records, pixels) sized to a memory budget, every record of a
  tile blended until each of its pixels is saturated; ``backward``
  recomputes each block under autograd, last block first, carrying the
  transmittance's cotangent between blocks, so a full-size frame's
  gradient fits on the card.

``Precision`` stores every intermediate in a lower type for the control
(``bfloat16``); at ``float32`` it is the identity. Matrix products run
without TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Tuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Rounds intermediates to ``dtype`` (the control's lower precision)."""
    dtype: torch.dtype = torch.float32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32 or not x.is_floating_point():
            return x
        return x.to(self.dtype).to(torch.float32)


FP32 = Precision()


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in float32, not TF32."""
    m = torch.backends.cuda.matmul
    was = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = was


@dataclasses.dataclass(frozen=True)
class Frame:
    """A frame's size and the renderer's constants."""
    width: int
    height: int
    tile_px: int
    sh_degree: int = 0
    dilation: float = 0.3
    radius_sigma: float = 3.0
    fov_margin: float = 1.3
    w_eps: float = 1e-4
    eig_floor: float = 0.1
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    saturation: float = 0.99
    color_scale: float = 255.0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def grid(self) -> Tuple[int, int]:
        return -(-self.width // self.tile_px), -(-self.height // self.tile_px)

    @property
    def tiles(self) -> int:
        gx, gy = self.grid
        return gx * gy

    @property
    def pitch(self) -> Tuple[int, int]:
        """A tile's pixels across and down: the image padded up to whole
        tiles of the grid."""
        gx, gy = self.grid
        return -(-self.width // gx), -(-self.height // gy)

    @property
    def pixels_per_tile(self) -> int:
        pw, ph = self.pitch
        return pw * ph


def frame_of(cfg: dict) -> Frame:
    """The Frame of a benchmark configuration."""
    return Frame(width=int(cfg["width"]), height=int(cfg["height"]),
                 tile_px=int(cfg["render"]["tile_px"]),
                 sh_degree=int(cfg["sh_degree"]))


def _mat(m, device) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(N, 6) packed Sigma = R S^2 R^T of wxyz quaternions
    (``Splats.cpp:414-479``): xx, xy, xz, yy, yz, zz."""
    r, x, y, z = quats.unbind(-1)
    sx, sy, sz = scales.unbind(-1)
    m = [[(1 - 2 * (y * y + z * z)) * sx, 2 * (x * y - r * z) * sy, 2 * (x * z + r * y) * sz],
         [2 * (x * y + r * z) * sx, (1 - 2 * (x * x + z * z)) * sy, 2 * (y * z - r * x) * sz],
         [2 * (x * z - r * y) * sx, 2 * (y * z + r * x) * sy, (1 - 2 * (x * x + y * y)) * sz]]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return torch.stack([dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2),
                        dot(2, 2)], dim=-1)


def sh_color(colors, sh_rest, means, view, degree: int, scale: float):
    """View-dependent colour (0.5 + SH(dir)) * scale, degree 0 being the
    DC colour itself; ``sh_rest`` channel-major (3 x 15)."""
    if degree <= 0 or sh_rest is None:
        return colors
    r, t = view[:3, :3], view[:3, 3]
    d = means - (-(r.T @ t))[None, :]
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=1, keepdim=True), 1e-12)
    c = SH_C0 * ((colors / scale - 0.5) / SH_C0)
    sh = sh_rest.reshape(sh_rest.shape[0], 3, -1).transpose(1, 2)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = c - SH_C1 * y * sh[:, 0] + SH_C1 * z * sh[:, 1] - SH_C1 * x * sh[:, 2]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * sh[:, 3] + SH_C2[1] * yz * sh[:, 4]
             + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 5]
             + SH_C2[3] * xz * sh[:, 6] + SH_C2[4] * (xx - yy) * sh[:, 7])
    if degree >= 3:
        c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 8]
             + SH_C3[1] * xy * z * sh[:, 9]
             + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 10]
             + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 11]
             + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 12]
             + SH_C3[5] * z * (xx - yy) * sh[:, 13]
             + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 14])
    return (0.5 + c) * scale


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncation toward zero, NaN to 0, out of range saturated."""
    big = float(2 ** 31 - 128)
    return torch.nan_to_num(x, nan=0.0).clamp(-big, big).to(torch.int32)


def project(params: Dict[str, torch.Tensor], cam: dict, fr: Frame,
            prec: Precision = FP32) -> Dict[str, torch.Tensor]:
    """Every splat on screen: ``fields`` (N, 9) = mean2d x, y, conic A, B,
    C, opacity, colour r, g, b (differentiable); ``depth`` (N,) ndc z in
    [0, 1]; ``tile_min``, ``tile_ext`` (N, 2) int32; ``counts`` (N,) the
    tiles each splat's rectangle covers (0 where it is culled, degenerate
    or below the alpha floor)."""
    q = prec
    dev = params["means"].device
    view, vp = _mat(cam["view"], dev), _mat(cam["vp"], dev)
    means = q(params["means"])
    cov6 = q(covariance(q(params["scales"]), q(params["quats"])))
    mx, my, mz = means.unbind(1)

    def apply(mat):
        return [mx * mat[j, 0] + my * mat[j, 1] + mz * mat[j, 2] + mat[j, 3] for j in range(4)]

    p0, p1, p2, p3 = apply(vp)
    w = torch.clamp_min(p3, fr.w_eps)
    nx, ny, nz = p0 / w, p1 / w, p2 / w
    culled = (nx.abs() > 1.0) | (ny.abs() > 1.0)
    sx = q((nx + 1.0) * 0.5 * fr.width)
    sy = q((ny + 1.0) * 0.5 * fr.height)
    depth = (nz + 1.0) * 0.5

    t0, t1, tz, _ = apply(view)
    limx = -fr.fov_margin * float(cam["tan_fovx"])
    limy = -fr.fov_margin * float(cam["tan_fovy"])
    # the reference's clamp as written: min(lim, max(-lim, x)), lim = -1.3 tan
    tx = torch.clamp(torch.clamp(t0 / tz, min=-limx), max=limx) * tz
    ty = torch.clamp(torch.clamp(t1 / tz, min=-limy), max=limy) * tz
    v3 = view[:3, :3]
    inv_tz = 1.0 / tz
    fx, fy = float(cam["focal_x"]), float(cam["focal_y"])
    u0 = (fx * inv_tz)[:, None] * v3[0][None, :] - (fx * tx * inv_tz * inv_tz)[:, None] * v3[2][None, :]
    u1 = (fy * inv_tz)[:, None] * v3[1][None, :] - (fy * ty * inv_tz * inv_tz)[:, None] * v3[2][None, :]

    def quad(u, v):
        a, b, c, d, e, f = cov6.unbind(1)
        return (a * u[:, 0] * v[:, 0] + d * u[:, 1] * v[:, 1] + f * u[:, 2] * v[:, 2]
                + b * (u[:, 0] * v[:, 1] + u[:, 1] * v[:, 0])
                + c * (u[:, 0] * v[:, 2] + u[:, 2] * v[:, 0])
                + e * (u[:, 1] * v[:, 2] + u[:, 2] * v[:, 1]))

    a2 = q(quad(u0, u0) + fr.dilation)
    b2 = q(quad(u0, u1))
    c2 = q(quad(u1, u1) + fr.dilation)
    det = a2 * c2 - b2 * b2
    degenerate = (det == 0.0) | ~torch.isfinite(det) | ~torch.isfinite(sx) | ~torch.isfinite(sy)
    valid = ~culled & ~degenerate
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = q(torch.stack([c2 * inv_det, -b2 * inv_det, a2 * inv_det], dim=1))
    opac = q(params["opacities"])

    mid = 0.5 * (a2 + c2)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, fr.eig_floor))
    radius = torch.ceil(fr.radius_sigma * torch.sqrt(torch.clamp_min(lam_max, 0.0)))
    lam = torch.log(torch.clamp_min(opac, 1e-30) / fr.alpha_min)
    two_l = 2.0 * torch.clamp_min(lam, 0.0)
    rx = torch.minimum(radius, torch.sqrt(two_l * torch.clamp_min(a2, 0.0)) + 1e-3).detach()
    ry = torch.minimum(radius, torch.sqrt(two_l * torch.clamp_min(c2, 0.0)) + 1e-3).detach()
    reach = valid & (opac >= fr.alpha_min)
    gx, gy = fr.grid
    pw, ph = (float(v) for v in fr.pitch)
    x0 = _to_i32((sx - rx) / pw).clamp(0, gx - 1)
    x1 = _to_i32((sx + rx) / pw).clamp(0, gx - 1)
    y0 = _to_i32((sy - ry) / ph).clamp(0, gy - 1)
    y1 = _to_i32((sy + ry) / ph).clamp(0, gy - 1)
    ext_x, ext_y = x1 - x0 + 1, y1 - y0 + 1
    counts = torch.where(reach, ext_x * ext_y, torch.zeros_like(ext_x))

    color = q(sh_color(params["colors"], params.get("sh_rest"), params["means"], view,
                       fr.sh_degree, fr.color_scale))
    fields = torch.cat([torch.stack([sx, sy], 1), conic, opac[:, None], color], dim=1)
    return {"fields": fields, "depth": depth.detach(),
            "tile_min": torch.stack([x0, y0], 1), "tile_ext": torch.stack([ext_x, ext_y], 1),
            "counts": counts.to(torch.int32)}


def bin_and_sort(proj: Dict[str, torch.Tensor], fr: Frame):
    """Records (one a covered tile of each splat, splat-major), stably
    sorted by (tile, depth). Returns (splat id of each sorted record (R,)
    int64, per-tile bounds (T + 1,) int64, R)."""
    counts = proj["counts"].long()
    dev = counts.device
    n = counts.shape[0]
    total = int(counts.sum())
    sid = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(total, device=dev) - first[sid]
    ext_x = proj["tile_ext"][:, 0].long()[sid]
    tx = proj["tile_min"][:, 0].long()[sid] + j % ext_x
    ty = proj["tile_min"][:, 1].long()[sid] + j // ext_x
    tile = ty * fr.grid[0] + tx
    del j, ext_x, tx, ty
    _, by_depth = torch.sort(proj["depth"][sid], stable=True)
    _, by_tile = torch.sort(tile[by_depth], stable=True)
    order = by_depth[by_tile]
    sorted_sid = sid[order]
    per_tile = torch.bincount(tile, minlength=fr.tiles)
    bounds = torch.cat([per_tile.new_zeros(1), torch.cumsum(per_tile, 0)])
    return sorted_sid, bounds, total


def _pixel_coords(fr: Frame, device):
    """(T, P) pixel x and y of every tile's pixels, row major in a tile."""
    gx, gy = fr.grid
    pw, ph = fr.pitch
    lane = torch.arange(pw * ph, device=device)
    tiles = torch.arange(gx * gy, device=device)
    px = (tiles % gx)[:, None] * pw + (lane % pw)[None, :]
    py = (tiles // gx)[:, None] * ph + (lane // pw)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


class Compositor:
    """Blends (tile, depth)-sorted records, tile block by tile block.

    ``forward`` returns ((T, P, 3) colour in colour-scale units, (T, P)
    transmittance). With ``keep=True`` it keeps each block's plan and its
    incoming transmittance, which ``backward`` needs."""

    def __init__(self, fr: Frame, prec: Precision = FP32, pair_budget: int = 1 << 25):
        self.fr, self.prec, self.budget = fr, prec, pair_budget
        self.plan: List[tuple] = []

    def _block(self, r, live, t_in, px, py):
        """One block: records r (A, K, 9), live (A, K), incoming
        transmittance (A, P); pixel coords (A, 1, P). Returns (A, P, 3)
        colour and the outgoing transmittance (A, P)."""
        q, fr = self.prec, self.fr
        dx = px - r[:, :, 0:1]
        dy = py - r[:, :, 1:2]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        alpha = torch.clamp_max(torch.exp(torch.clamp_max(power, 0.0)) * r[:, :, 5:6],
                                fr.alpha_max)
        keep = live[:, :, None] & (power <= 0.0) & (alpha >= fr.alpha_min)
        alpha = q(torch.where(keep, alpha, torch.zeros_like(alpha)))
        one_m = 1.0 - alpha
        run = torch.cumprod(one_m, dim=1)
        before = q(t_in[:, None, :] * torch.cat([torch.ones_like(run[:, :1]), run[:, :-1]], 1))
        inc = before > 1.0 - fr.saturation
        wgt = q(alpha * before * inc)
        color = torch.einsum("akp,akc->apc", wgt, r[:, :, 6:9])
        t_out = t_in * torch.where(inc, one_m, torch.ones_like(one_m)).prod(1)
        return q(color), q(t_out)

    def _take(self, rec, starts, cnt, pos, tiles, k):
        lane = torch.arange(k, device=rec.device)
        live = lane[None, :] < (cnt[tiles] - pos[tiles])[:, None]
        idx = torch.where(live, starts[tiles, None] + pos[tiles, None] + lane[None, :],
                          torch.zeros((), dtype=torch.long, device=rec.device))
        return idx, live

    def forward(self, rec: torch.Tensor, bounds: torch.Tensor, keep: bool = False):
        fr = self.fr
        dev = rec.device
        t, p = fr.tiles, fr.pixels_per_tile
        pxs, pys = _pixel_coords(fr, dev)
        starts, cnt = bounds[:-1].long(), (bounds[1:] - bounds[:-1]).long()
        pos = torch.zeros(t, dtype=torch.long, device=dev)
        rgb = torch.zeros((t, p, 3), dtype=torch.float32, device=dev)
        trans = torch.ones((t, p), dtype=torch.float32, device=dev)
        self.plan = []
        active = torch.nonzero(cnt > 0).squeeze(1)
        budget = self.budget if rec.is_cuda else min(self.budget, 1 << 18)
        with torch.no_grad(), no_tf32():
            while active.numel():
                k = max(16, min(1 << 14, 1 << int(math.log2(max(1, budget // (active.numel() * p))))))
                idx, live = self._take(rec, starts, cnt, pos, active, k)
                t_in = trans[active]
                if keep:
                    self.plan.append((active, pos[active].clone(), k, t_in))
                c, t_out = self._block(rec[idx], live, t_in, pxs[active, None, :],
                                       pys[active, None, :])
                rgb[active] += c
                trans[active] = t_out
                pos[active] += k
                go = (pos[active] < cnt[active]) & (t_out > 1.0 - fr.saturation).any(1)
                active = active[go]
        return rgb, trans

    def backward(self, rec: torch.Tensor, bounds: torch.Tensor, g_rgb: torch.Tensor,
                 g_trans: torch.Tensor) -> torch.Tensor:
        """The records' cotangents (R, 9) for cotangents of ``forward``'s
        outputs, from the plan the last ``forward(keep=True)`` kept."""
        fr = self.fr
        dev = rec.device
        pxs, pys = _pixel_coords(fr, dev)
        starts, cnt = bounds[:-1].long(), (bounds[1:] - bounds[:-1]).long()
        grad = torch.zeros_like(rec)
        g_t = g_trans.clone()
        pos = torch.zeros(fr.tiles, dtype=torch.long, device=dev)
        with no_tf32():
            for tiles, pos0, k, t_in in reversed(self.plan):
                pos[tiles] = pos0
                idx, live = self._take(rec, starts, cnt, pos, tiles, k)
                r = rec[idx].detach().requires_grad_(True)
                tin = t_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    c, t_out = self._block(r, live, tin, pxs[tiles, None, :], pys[tiles, None, :])
                    gr, gt = torch.autograd.grad((c, t_out), (r, tin),
                                                 (g_rgb[tiles], g_t[tiles]))
                grad.index_add_(0, idx[live], gr[live])
                g_t[tiles] = gt
        self.plan = []
        return grad


def assemble(rgb: torch.Tensor, trans: torch.Tensor, fr: Frame) -> torch.Tensor:
    """(T, P, 3) colour + (T, P) transmittance -> the (H, W, 4) image in
    [0, 1] over the background."""
    gx, gy = fr.grid
    pw, ph = fr.pitch
    bg = torch.tensor(fr.background, dtype=torch.float32, device=rgb.device)
    tiled = torch.cat([rgb / fr.color_scale + trans[..., None] * bg, (1.0 - trans)[..., None]], -1)
    img = tiled.reshape(gy, gx, ph, pw, 4).permute(0, 2, 1, 3, 4).reshape(gy * ph, gx * pw, 4)
    return img[:fr.height, :fr.width]


def untile(g_img: torch.Tensor, fr: Frame) -> Tuple[torch.Tensor, torch.Tensor]:
    """``assemble``'s transpose: the (H, W, 4) image's cotangent -> the
    cotangents of (T, P, 3) colour and (T, P) transmittance."""
    gx, gy = fr.grid
    pw, ph = fr.pitch
    full = g_img.new_zeros((gy * ph, gx * pw, 4))
    full[:fr.height, :fr.width] = g_img
    tiled = full.reshape(gy, ph, gx, pw, 4).permute(0, 2, 1, 3, 4).reshape(gx * gy, pw * ph, 4)
    bg = torch.tensor(fr.background, dtype=torch.float32, device=g_img.device)
    g_rgb = tiled[..., :3] / fr.color_scale
    g_trans = (tiled[..., :3] * bg).sum(-1) - tiled[..., 3]
    return g_rgb.contiguous(), g_trans.contiguous()


def render(params: Dict[str, torch.Tensor], cam: dict, fr: Frame,
           prec: Precision = FP32, pair_budget: int = 1 << 25):
    """The (H, W, 4) image and its record count, without gradients."""
    with torch.no_grad():
        proj = project(params, cam, fr, prec)
        sid, bounds, total = bin_and_sort(proj, fr)
        rec = proj["fields"][sid]
        del proj
        rgb, trans = Compositor(fr, prec, pair_budget).forward(rec, bounds)
        return assemble(rgb, trans, fr), total
