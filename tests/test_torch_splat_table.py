"""The splat table (``ops/kernels/table.py``) on the CPU against the JAX
package's jitted stage and against torch autograd.

Scenes of 40 splats at 64x64 are drawn with numpy from a seed and fed to
both packages, with splats placed on purpose: behind the camera,
off-screen, inside and past the reference's fov clamp, and at zero scale
(a degenerate det where the dilation is 0). The cases cover SH degrees
0-3, ``antialiased``, ``tight_rect`` and ``int_tile_size`` on and off (the
grid is 12 x 12, so the tile pitch is not a power of two and the two rect
divisors differ), the cov6 route and ``shift2d``.

- forward: the wrapper on CPU tensors equals the stage it replaced in
  ``ops/fastpath.py`` (``projection.preprocess``, ``effective_colors`` and
  the field stack, composed here) bit for bit, every output and prep key;
- backward: the gradients through ``SplatTable`` (whose CPU backward is
  ``splat_table_bwd_plain``, the kernel's analytic formulas in torch)
  within 1e-4 of each tensor's largest gradient of ``jax.vjp`` of the JAX
  package's preprocess + ``effective_colors`` + table rows (the card's
  contract is 5e-3), and within 1e-5 of torch autograd of the plain
  forward on the same float32 inputs. Under ``tight_rect`` JAX's VJP is
  NaN at a degenerate splat (det == 0 at zero scale and no dilation): its
  rect takes sqrt(2 L a2d) at a2d = 0 ahead of the stop_gradient, and the
  infinite slope meets a zero cotangent. Torch autograd and the analytic
  backward are finite there; those splats, and only those, are left out
  of the JAX comparison;
- on CPU tensors the wrapper counts no launch, and ``SplatTable``'s
  gradients are ``splat_table_bwd_plain``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.ops import projection as jax_projection
from openglgaussiansplattingrenderer_tpu.ops.transforms import build_covariance as jax_cov
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.render import effective_colors as jax_colors

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath, projection
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance
from openglgaussiansplattingrenderer_tpu_torch.render import effective_colors
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, W, H = 40, 64, 64
JAX_TOL, AUTOGRAD_TOL = 1e-4, 1e-5
# (sh_degree, antialiased, tight_rect, int_tile_size, cov6 route, shift2d, dilation)
CASES = {
    "sh0": (0, False, True, False, False, False, 0.3),
    "sh1-aa-int-shift": (1, True, False, True, False, True, 0.3),
    "sh2-cov6-shift": (2, False, False, False, True, True, 0.3),
    "sh3-aa-tight-cov6": (3, True, True, False, True, False, 0.3),
    "sh3-tight-int-shift": (3, False, True, True, False, True, 0.3),
    "sh0-aa-degenerate": (0, True, True, False, False, False, 0.0),
    "sh0-int-cov6-shift-degenerate": (0, False, False, True, True, True, 0.0),
}


def _camera():
    a = jax_camera_args(JaxCamera(0.0, 0.0, -4.0, width=W, height=H))
    return a["view"], a["vp"], (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])


def _scene(seed=3):
    """40 splats: 30 around the origin, then two behind the camera, two
    off-screen, two inside and two past the fov clamp (x and y), and two
    at zero scale. Returns a dict of float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    view, _, (_, _, tfx, tfy) = _camera()
    inv = np.linalg.inv(view.astype(np.float64))
    tz = float((view @ np.array([0.0, 0.0, 0.0, 1.0]))[2])     # the origin, in front
    limx, limy = -1.3 * float(tfx), -1.3 * float(tfy)

    def at(tx, ty, t_z):
        return (inv @ np.array([tx, ty, t_z, 1.0]))[:3]

    means = np.concatenate([
        rng.uniform(-1.2, 1.2, (30, 3)),
        [at(0.3, 0.1, -tz), at(-0.2, 0.4, -0.5 * tz)],              # behind
        [at(3.0 * tz, 0.0, tz), at(0.0, -2.5 * tz, tz)],              # off-screen
        [at(0.5 * limx * tz, 0.0, tz), at(0.0, 0.6 * limy * tz, tz)],  # inside the clamp
        [at(2.0 * limx * tz, 0.1, tz), at(0.1, -2.0 * limy * tz, tz)],  # past it
        rng.uniform(-0.5, 0.5, (2, 3)),                               # zero scale
    ])
    scales = np.exp(rng.uniform(-3.5, -1.5, (N, 3)))
    scales[-2:] = 0.0
    quats = rng.normal(size=(N, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scene = dict(means=means, scales=scales, quats=quats,
                 opacities=rng.uniform(0.05, 0.95, N), colors=rng.uniform(0, 255, (N, 3)),
                 sh_rest=rng.normal(0.0, 0.3, (N, 45)), shift2d=rng.normal(0.0, 0.5, (N, 2)))
    return {k: v.astype(np.float32) for k, v in scene.items()}


def _case(name):
    """(scene dict, torch config, JAX config) of a case; the scene keeps
    only the inputs the case routes (cov6 or scales + quats, sh_rest,
    shift2d)."""
    sh, aa, tight, int_tile, cov6, shift, dil = CASES[name]
    opts = dict(grid_x=12, grid_y=12, sh_degree=sh, antialiased=aa, tight_rect=tight,
                int_tile_size=int_tile, dilation=dil)
    scene = _scene()
    if cov6:
        scene["cov6"] = np.asarray(jax_cov(jnp.asarray(scene.pop("scales")),
                                           jnp.asarray(scene.pop("quats"))))
    if not sh:
        del scene["sh_rest"]
    if not shift:
        del scene["shift2d"]
    return scene, RenderConfig(**opts), JaxConfig(**opts)


def _targs(cfg):
    view, vp, cam = _camera()
    return (torch.from_numpy(view), torch.from_numpy(vp)) + cam + (W, H, cfg)


def _replaced_stage(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy, width,
                    height, cfg):
    """What ``fastpath.splat_table`` computed before the kernel, composed
    from the functions it called."""
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(params["means"], cov6, params["opacities"], view, vp,
                                 width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    colors = effective_colors(params, view, cfg)
    mean2d = prep["mean2d"] + params["shift2d"] if "shift2d" in params else prep["mean2d"]
    fields = torch.stack([mean2d[:, 0], mean2d[:, 1], *prep["conic"].t(), prep["opacity"],
                          *colors.t()])
    zero = torch.zeros(())
    depth = torch.where(prep["valid"], prep["depth"], zero)
    depth = torch.where(torch.isfinite(depth), depth, zero)
    return (fields, prep["tile_min"], prep["tile_ext"], depth), prep


def _leaves(scene):
    return {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in scene.items()}


def _cotangent():
    return np.random.default_rng(17).normal(size=(9, N)).astype(np.float32)


def _assert_scaled_close(got, want, tol, what, rows=slice(None)):
    for k, w in want.items():
        w = np.asarray(w)[rows]
        scale = np.abs(w).max()
        assert scale > 0, f"{what} {k}: the reference gradient is all zero"
        err = np.abs(np.asarray(got[k])[rows] - w).max() / scale
        assert err <= tol, f"{what} {k}: {err:.3e} of the largest gradient"


@pytest.mark.parametrize("name", list(CASES))
def test_forward_equals_the_replaced_stage(name):
    scene, cfg, _ = _case(name)
    params = {k: torch.from_numpy(v.copy()) for k, v in scene.items()}
    before = (kt.splat_table.launches, kt.splat_table_bwd.launches)
    table, prep = fastpath.splat_table(params, *_targs(cfg))
    want_table, want_prep = _replaced_stage(params, *_targs(cfg))
    for a, b in zip(table, want_table):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert set(prep) == set(want_prep)
    for k in prep:
        assert prep[k].dtype == want_prep[k].dtype, k
        assert torch.equal(prep[k], want_prep[k]) or (
            k == "depth" and torch.allclose(prep[k], want_prep[k], equal_nan=True)), k
    # the placed splats do what they were placed for
    assert bool(prep["culled"][30:34].all()) and not bool(prep["culled"][:30].all())
    assert int(prep["counts"].sum()) > 0
    if cfg.dilation == 0.0:
        assert not bool(prep["valid"][-2:].any())          # det == 0 at zero scale
    assert (kt.splat_table.launches, kt.splat_table_bwd.launches) == before


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_jax_vjp(name):
    scene, cfg, jcfg = _case(name)
    view, vp, cam = _camera()
    keys = list(scene)

    def jax_fields(*xs):
        p = dict(zip(keys, xs))
        cov6 = p["cov6"] if "cov6" in p else jax_cov(p["scales"], p["quats"])
        prep = jax_projection.preprocess(p["means"], cov6, p["opacities"],
                                         jnp.asarray(view), jnp.asarray(vp), W, H, *cam, jcfg)
        colors = jax_colors(p, jnp.asarray(view), jcfg)
        mean2d = prep["mean2d"] + p["shift2d"] if "shift2d" in p else prep["mean2d"]
        return jnp.stack([mean2d[:, 0], mean2d[:, 1], prep["conic"][:, 0],
                          prep["conic"][:, 1], prep["conic"][:, 2], prep["opacity"],
                          colors[:, 0], colors[:, 1], colors[:, 2]])

    fields_j, vjp = jax.vjp(jax_fields, *(jnp.asarray(scene[k]) for k in keys))
    g = _cotangent()
    want = dict(zip(keys, (np.asarray(d) for d in vjp(jnp.asarray(g)))))

    leaves = _leaves(scene)
    (fields, _, _, _), prep = fastpath.splat_table(leaves, *_targs(cfg))
    np.testing.assert_allclose(fields.detach().numpy(), np.asarray(fields_j), rtol=1e-5,
                               atol=1e-4)
    got = dict(zip(keys, torch.autograd.grad(fields, list(leaves.values()),
                                             torch.from_numpy(g))))
    finite = np.all([np.isfinite(w).reshape(N, -1).all(axis=1) for w in want.values()],
                    axis=0)
    degenerate = ~prep["valid"].numpy() & (cfg.dilation == 0.0) & (np.arange(N) >= N - 2)
    assert not (~finite & ~degenerate).any(), np.nonzero(~finite)
    assert all(np.isfinite(v.numpy()).all() for v in got.values())
    _assert_scaled_close({k: v.numpy() for k, v in got.items()}, want, JAX_TOL, name,
                         rows=finite)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_torch_autograd(name):
    scene, cfg, _ = _case(name)
    g = torch.from_numpy(_cotangent())
    targs = _targs(cfg)
    leaves = _leaves(scene)
    (fields, _, _, _), _ = kt.splat_table_plain(leaves, *targs)   # torch's own graph
    want = torch.autograd.grad(fields, list(leaves.values()), g)
    inputs = kt.table_inputs({k: v.detach() for k, v in leaves.items()}, cfg)
    got = kt.splat_table_bwd_plain(inputs, targs[0], targs[1], targs[2:], g)
    if "shift2d" in scene:
        got["shift2d"] = g[0:2].t()
    _assert_scaled_close({k: got[k].numpy() for k in scene},
                         {k: w.numpy() for k, w in zip(leaves, want)}, AUTOGRAD_TOL, name)


def test_the_function_runs_the_plain_backward_on_cpu():
    scene, cfg, _ = _case("sh3-tight-int-shift")
    targs = _targs(cfg)
    g, gm = torch.from_numpy(_cotangent()), torch.linspace(-1.0, 1.0, 2 * N).reshape(N, 2)
    leaves = _leaves(scene)
    before = (kt.splat_table.launches, kt.splat_table_bwd.launches)
    (fields, _, _, _), prep = kt.splat_table(leaves, *targs)
    got = torch.autograd.grad((fields, prep["mean2d"]), list(leaves.values()), (g, gm))
    inputs = kt.table_inputs({k: v.detach() for k, v in leaves.items()}, cfg)
    want = kt.splat_table_bwd_plain(inputs, targs[0], targs[1], targs[2:], g, gm)
    want["shift2d"] = g[0:2].t()
    for k, v in zip(leaves, got):
        assert torch.equal(v, want[k]), k
    assert (kt.splat_table.launches, kt.splat_table_bwd.launches) == before
    # a splat without a cotangent gets a zero gradient
    g[:, 5] = 0.0
    gm[5] = 0.0
    zero = kt.splat_table_bwd_plain(inputs, targs[0], targs[1], targs[2:], g, gm)
    assert all(not bool(v[5].any()) for v in zero.values())


def test_bad_inputs_raise():
    scene, cfg, _ = _case("sh0")
    targs = _targs(cfg)
    params = {k: torch.from_numpy(v.copy()) for k, v in scene.items()}
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kt.splat_table({k: v.to("meta") for k, v in params.items()}, *targs)
    inputs = kt.table_inputs(params, dataclasses.replace(cfg, sh_degree=3))
    assert inputs["sh_rest"] is None and inputs["cov6"] is None
    with pytest.raises(ValueError, match="sh_rest rows"):
        kt._sh_row("t", torch.zeros((N, 9)), dataclasses.replace(cfg, sh_degree=2), 45)
    assert kt._sh_row("t", torch.zeros((N, 24)), dataclasses.replace(cfg, sh_degree=2), 45) == 24
