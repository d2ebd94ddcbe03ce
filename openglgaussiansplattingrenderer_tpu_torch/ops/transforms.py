"""Splat-parameter transforms on torch tensors.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/transforms.py``
with the same formulas in the same operation order (the parity tests hold
the two packages to 1e-5):

- quaternion + scale -> 3D covariance, 6-float symmetric packing
  (ref ``src/Splats.cpp:414-479``: Sigma = R diag(s)^2 R^T)
- spherical-harmonic colour up to degree 3

The packed covariance layout is the row-major upper triangle
(xx, xy, xz, yy, yz, zz) (``src/Splats.cpp:430-435``).
"""

from __future__ import annotations

import torch

# From graphdeco-inria/diff-gaussian-rasterization, cited by the reference at
# src/Splats.cpp:274-275.
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def color_to_dc(c, color_scale: float = 255.0):
    return (c / color_scale - 0.5) / SH_C0


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotation matrices
    (``src/Splats.cpp:454-458``)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(N, 3) scales + (N, 4) wxyz quats -> (N, 6) packed Sigma = R S^2 R^T,
    written elementwise in the JAX package's order."""
    r, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    m = [
        [(1 - 2 * (y * y + z * z)) * sx, 2 * (x * y - r * z) * sy,
         2 * (x * z + r * y) * sz],
        [2 * (x * y + r * z) * sx, (1 - 2 * (x * x + z * z)) * sy,
         2 * (y * z - r * x) * sz],
        [2 * (x * z - r * y) * sx, 2 * (y * z + r * x) * sy,
         (1 - 2 * (x * x + y * y)) * sz],
    ]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return torch.stack([dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2),
                        dot(2, 2)], dim=-1)


def unpack_covariance(cov6: torch.Tensor) -> torch.Tensor:
    """(N, 6) packed -> (N, 3, 3) symmetric matrices."""
    a, b, c, d, e, f = (cov6[..., i] for i in range(6))
    return torch.stack([torch.stack([a, b, c], dim=-1),
                        torch.stack([b, d, e], dim=-1),
                        torch.stack([c, e, f], dim=-1)], dim=-2)


def covariance_quadratic_form(cov6, u, v):
    """u^T Sigma v for packed (..., 6) covariances and (..., 3) vectors."""
    a, b, c, d, e, f = (cov6[..., i] for i in range(6))
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return (a * u0 * v0 + d * u1 * v1 + f * u2 * v2
            + b * (u0 * v1 + u1 * v0)
            + c * (u0 * v2 + u2 * v0)
            + e * (u1 * v2 + u2 * v1))


def eval_sh(dc, sh_rest, dirs, degree: int, color_scale: float = 255.0):
    """View-dependent colour from SH coefficients.

    dc (N, 3) f_dc; sh_rest (N, 45) f_rest, channel-major (15 coeffs x 3
    channels, channel outer); dirs (N, 3) unit view directions. Returns
    (0.5 + SH(dir)) * color_scale, degree 0 being ``Splats.cpp:295``.
    """
    c = SH_C0 * dc
    if degree >= 1:
        sh = sh_rest.reshape(sh_rest.shape[0], 3, -1).transpose(1, 2)
        x = dirs[:, 0:1]
        y = dirs[:, 1:2]
        z = dirs[:, 2:3]
        c = c - SH_C1 * y * sh[:, 0] + SH_C1 * z * sh[:, 1] - SH_C1 * x * sh[:, 2]
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            c = (c + SH_C2[0] * xy * sh[:, 3]
                 + SH_C2[1] * yz * sh[:, 4]
                 + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 5]
                 + SH_C2[3] * xz * sh[:, 6]
                 + SH_C2[4] * (xx - yy) * sh[:, 7])
        if degree >= 3:
            c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 8]
                 + SH_C3[1] * xy * z * sh[:, 9]
                 + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 10]
                 + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 11]
                 + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 12]
                 + SH_C3[5] * z * (xx - yy) * sh[:, 13]
                 + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 14])
    return (0.5 + c) * color_scale


def camera_center_from_view(view: torch.Tensor) -> torch.Tensor:
    """World-space camera centre of a view matrix [R|t]: -R^T t."""
    r = view[:3, :3]
    t = view[:3, 3]
    return -(r.T @ t)
