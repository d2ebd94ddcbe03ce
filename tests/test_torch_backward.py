"""The port's backward render path on the CPU (the plain versions of its
backward kernels, inside the same ``torch.autograd.Function``s the card
uses) against the JAX package's Pallas backward kernels in interpret mode.

- compositor backward: JAX's own sorted records and bounds and one numpy
  cotangent through ``jax.vjp`` of ``composite_sorted`` and through the
  port's ``Composite``; each of the 9 rows within rtol 2e-3 (the JAX
  suite's Pallas-vs-jnp tolerance) and an atol of 3e-6 of the row's
  largest gradient, rtol 5e-3 on the saturated scene. The JAX kernel forms
  the moments of dx, dy by expanding them around the tile origin
  (sxy - mx*sy - my*sx + mx*my*s1), sums that cancel; the port sums
  dpower*dx*dy directly. So an element far below its row's scale differs
  by a few 1e-6 of that scale (seen: 1.5e-6, one element in 4096).
- segment sum: a numpy cotangent through ``jax.vjp`` of the JAX expand op
  and through ``Expand``'s backward, 1e-6 of the row's largest sum (sums of
  a few floats in another order), with overflow and with empty splats.
- record sort: the backward is the exact inverse permutation.
- whole frame: ``torch.autograd.grad`` against ``jax.grad`` of the JAX fast
  path, every parameter tensor within 5e-3 of its largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops import fastpath as jax_fastpath
from openglgaussiansplattingrenderer_tpu.ops.pallas import records as jax_records
from openglgaussiansplattingrenderer_tpu.render import camera_args
from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays

BASE = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)


def _scene(name):
    """(scene dict without sh_rest, camera z, width, height, config options)."""
    if name == "saturated":
        # heavy overdraw: the early exit and the saturation masks
        sc = jax_ply.make_synthetic_scene(120, seed=4, extent=0.4)
        sc["opacities"] = np.full(120, 0.95, np.float32)
        sc["scales"] = np.full((120, 3), 0.15, np.float32)
        out = sc, -2.0, 32, 32, dict(BASE, dup_capacity_factor=80.0)
    elif name == "60@64x64":
        sc = jax_ply.make_synthetic_scene(60, seed=21, extent=1.5)
        sc["opacities"] = np.clip(sc["opacities"], 0.2, 0.8)
        out = sc, -5.0, 64, 64, BASE
    else:
        seed, n, w, h = {"150@128x128": (3, 150, 128, 128),
                         "400@128x64": (9, 400, 128, 64)}[name]
        out = jax_ply.make_synthetic_scene(n, seed=seed, extent=2.0), -6.0, w, h, BASE
    return ({k: v for k, v in out[0].items() if k != "sh_rest"},) + out[1:]


def _camera(z, w, h, x=0.0, y=0.0):
    a = camera_args(Camera(x, y, z, width=w, height=h))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], w, h)


def _jargs(scene, args):
    return ({k: jnp.asarray(v) for k, v in scene.items()}, jnp.asarray(args[0]),
            jnp.asarray(args[1])) + tuple(args[2:])


def _assert_rows_close(got, want, rtol, atol_of_scale):
    for i, (g, w) in enumerate(zip(got, want)):
        scale = np.abs(w).max()
        assert scale > 0, f"row {i}: the reference gradient is all zero"
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_of_scale * scale,
                                   err_msg=f"row {i}")


@pytest.mark.parametrize("name,rtol,atol", [
    ("150@128x128", 2e-3, 3e-6), ("400@128x64", 2e-3, 3e-6),
    ("saturated", 5e-3, 3e-6)])
def test_composite_backward_matches_pallas(name, rtol, atol):
    scene, z, w, h, opts = _scene(name)
    jcfg = JaxConfig(**opts)
    _, out = jax_fastpath.render_fast(*_jargs(scene, _camera(z, w, h)), jcfg,
                                      stop_after="sort2")
    sf2, bounds = out["fields"], out["bounds"]
    t, cap = jcfg.num_tiles, sf2[0].shape[0]

    def f(fields):
        return jax_fastpath.composite_sorted(
            fields, bounds, capacity=cap, num_tiles=t,
            tile_ids=jnp.arange(t, dtype=jnp.int32), width=w, height=h,
            cfg=jcfg)[0]

    tiled_j, vjp = jax.vjp(f, sf2)
    g = np.random.default_rng(11).normal(size=tiled_j.shape).astype(np.float32)
    want = np.stack([np.asarray(d) for d in vjp(jnp.asarray(g))[0]])

    rec = torch.from_numpy(np.stack([np.array(x) for x in sf2])).requires_grad_(True)
    tb = torch.from_numpy(np.array(bounds))
    launches = kc.composite_bwd.launches
    tiled_t, _, _ = fastpath.composite_sorted(
        rec, tb, num_tiles=t, tile_ids=torch.arange(t, dtype=torch.int32),
        width=w, height=h, cfg=RenderConfig(**opts))
    (got,) = torch.autograd.grad(tiled_t, rec, torch.from_numpy(g))
    got = got.numpy()

    nrec = int(tb[-1])
    assert 0 < nrec < cap
    if name == "saturated":
        assert (np.asarray(tiled_j)[:, :, 3] <= 0.01).any()   # pixels did saturate
    _assert_rows_close(got, want, rtol, atol)
    # columns no tile owns get exactly zero, in both packages
    assert not got[:, nrec:].any() and not want[:, nrec:].any()
    assert kc.composite_bwd.launches == launches   # CPU tensors: the plain version


def test_composite_backward_zero_behind_a_saturated_tile():
    # one opaque splat in front of others over one 8x8 tile: once every
    # pixel has saturated, the later chunks' records get exactly zero
    n = 200
    rec = torch.zeros((9, n))
    rec[0], rec[1] = 3.5, 3.5
    rec[2], rec[4] = 1e-4, 1e-4          # a flat Gaussian: alpha = opacity
    rec[5] = 0.9
    rec[6:9] = torch.rand((3, n), generator=torch.Generator().manual_seed(0))
    rec.requires_grad_(True)
    bounds = torch.tensor([0, n], dtype=torch.int32)
    o = torch.zeros(1, dtype=torch.int32)
    out = kc.composite(rec, bounds, o, o, pw=8, ph=8, chunk=16, alpha_min=1 / 255,
                       alpha_max=0.99, thresh=0.01)
    assert float(out.detach()[..., 3].max()) <= 0.01
    (g,) = torch.autograd.grad(out.sum(), rec)
    assert g[:, :2].abs().sum() > 0
    assert not g[:, 16:].any()
    # an empty tile, and no tiles at all
    empty = kc.composite_bwd(rec.detach(), torch.tensor([0, 0], dtype=torch.int32),
                             o, o, out.detach(), out.detach(), pw=8, ph=8, chunk=16,
                             alpha_min=1 / 255, alpha_max=0.99, thresh=0.01)
    assert not empty.any()


def _jax_expand_vjp(fields, counts, capacity, g):
    """d fields (9, n) through jax.vjp of the JAX expand op, its inputs
    built as ``fastpath.expand_depth_records`` builds them."""
    rk = jax_records
    n = counts.shape[0]
    cum_incl_i = jnp.cumsum(jnp.asarray(counts))
    cum_excl_i = cum_incl_i - jnp.asarray(counts)
    total = jnp.minimum(cum_incl_i[-1], capacity).astype(jnp.int32)
    n_pad, n_seg = rk.round_up(n + rk.IB, 128), rk.round_up(n, rk.SB)

    def pad(x):
        return jnp.zeros(n_pad, jnp.float32).at[0:n].set(jnp.asarray(x, jnp.float32))

    cum_excl, cum_incl = pad(cum_excl_i), pad(cum_incl_i)
    zeros = jnp.zeros(n_pad, jnp.float32)
    # tile rect: one row of `count` tiles starting at tile 0
    table = jnp.stack([pad(r) for r in fields] + [zeros, zeros, pad(counts),
                                                  cum_excl, cum_incl, zeros, zeros])
    cum2 = jnp.stack([cum_excl, cum_incl] + [zeros] * 6)
    r0s = jnp.arange(capacity // rk.OB, dtype=jnp.int32) * rk.OB
    s0 = jax_fastpath._floor128(
        jnp.searchsorted(cum_incl_i, r0s, side="right").astype(jnp.int32))
    n0s = jnp.arange(n_seg // rk.SB, dtype=jnp.int32) * rk.SB
    a0 = jax_fastpath._floor128(
        jnp.minimum(cum_excl_i[jnp.minimum(n0s, n - 1)], total))
    seg_end = jnp.minimum(cum_incl_i[jnp.minimum(n0s + rk.SB - 1, n - 1)], total)
    nch = jnp.maximum(-(-(seg_end - a0) // rk.ICH), 0).astype(jnp.int32)
    op = rk.make_expand_op(capacity=capacity, gx=1 << 20, num_tiles=1 << 20,
                           n_seg_pad=n_seg)
    rec, vjp = jax.vjp(lambda tb: op(tb, cum2, s0, total[None], a0, nch), table)
    g16 = jnp.zeros((16, capacity), jnp.float32).at[0:9].set(jnp.asarray(g))
    return np.asarray(rec)[0:9], np.asarray(vjp(g16)[0])[0:9, 0:n]


@pytest.mark.parametrize("overflow", [False, True])
def test_segsum_matches_pallas(overflow):
    rng = np.random.default_rng(3)
    n, capacity = 900, 4096
    counts = rng.integers(0, 13 if overflow else 7, n).astype(np.int32)
    counts[rng.integers(0, n, 60)] = 0          # splats with no records
    counts[5] = 40                              # and one large span
    fields = rng.normal(size=(9, n)).astype(np.float32)
    g = rng.normal(size=(9, capacity)).astype(np.float32)
    total_all = int(counts.sum())
    assert (total_all > capacity) == overflow
    rec_j, want = _jax_expand_vjp(fields, counts, capacity, g)

    f = torch.from_numpy(fields).requires_grad_(True)
    cum = ks.cumsum(torch.from_numpy(counts))
    tile_min = torch.zeros((n, 2), dtype=torch.int32)
    tile_ext = torch.stack([torch.from_numpy(counts), torch.ones(n, dtype=torch.int32)],
                           dim=1)
    # alpha_min tiny and wide tiles: the cull keeps every record, as the
    # JAX op without its cull arguments does
    launches = kr.segsum.launches
    rec_t, tile, depth = kr.expand(f, tile_min, tile_ext, torch.zeros(n), cum,
                                   capacity=capacity, gx=1 << 20, num_tiles=1 << 20,
                                   pw=1 << 12, ph=1 << 12, alpha_min=1e-30)
    assert not tile.requires_grad and not depth.requires_grad
    total = min(total_all, capacity)
    np.testing.assert_array_equal(rec_t.detach().numpy()[:, :total], rec_j[:, :total])
    (got,) = torch.autograd.grad(rec_t, f, torch.from_numpy(g))
    got = got.numpy()

    _assert_rows_close(got, want, rtol=0, atol_of_scale=1e-6)
    assert not got[:, counts == 0].any()
    assert kr.segsum.launches == launches
    if overflow:
        # the splat that straddles total sums only its records below it,
        # and the splats past it get nothing
        cum_np = np.cumsum(counts)
        s = int(np.searchsorted(cum_np, capacity, side="right"))
        lo = int(cum_np[s - 1])
        assert lo < capacity < cum_np[s]
        np.testing.assert_allclose(got[:, s], g[:, lo:capacity].sum(axis=1), rtol=1e-5)
        assert not got[:, s + 1:].any()


def test_segsum_edge_cases():
    g = torch.ones((9, 8))
    assert kr.segsum(g, torch.zeros(0, dtype=torch.int32)).shape == (9, 0)
    out = kr.segsum(g, torch.tensor([0, 3, 3, 20], dtype=torch.int32))
    np.testing.assert_array_equal(out[0].numpy(), [0.0, 3.0, 0.0, 5.0])
    with pytest.raises(TypeError):
        kr.segsum(g, torch.tensor([1, 2]))                 # int64 prefix sum
    with pytest.raises(ValueError):
        kr.segsum(torch.ones((8, 8)), torch.tensor([1], dtype=torch.int32))


def test_sort_backward_is_the_inverse_permutation():
    rng = np.random.default_rng(7)
    key = torch.from_numpy(rng.integers(0, 50, 3000))          # many ties
    fields = torch.from_numpy(rng.normal(size=(9, 3000)).astype(np.float32))
    fields.requires_grad_(True)
    sk, si, sf = kr.sort_with_payload(key, fields)
    assert not sk.requires_grad and not si.requires_grad
    assert torch.equal(sf, fields[:, si]) and torch.equal(sk, key[si])
    g = torch.from_numpy(rng.normal(size=(9, 3000)).astype(np.float32))
    (back,) = torch.autograd.grad(sf, fields, g)
    # exact: each source column receives its sorted column's cotangent once
    assert torch.equal(back[:, si], g)
    assert torch.equal(back, g[:, torch.argsort(si)])


def _loss_torch(img, target):
    return torch.mean((img[..., :3] - target) ** 2) + 0.1 * torch.mean(img[..., 3])


def _loss_jax(img, target):
    return jnp.mean((img[..., :3] - target) ** 2) + 0.1 * jnp.mean(img[..., 3])


def _grads_both(scene, args, opts, target):
    loss_j, g_j = jax.value_and_grad(
        lambda p: _loss_jax(jax_render(p, *_jargs(scene, args)[1:],
                                       JaxConfig(**opts))[0], target))(
        {k: jnp.asarray(v) for k, v in scene.items()})
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    img, stats = render_arrays(p, *args, RenderConfig(**opts))
    loss_t = _loss_torch(img, target)
    g_t = dict(zip(p, torch.autograd.grad(loss_t, list(p.values()))))
    assert int(stats["overflow"]) == 0
    return float(loss_j), g_j, float(loss_t), g_t


def _assert_grads_close(g_t, g_j, tol=5e-3):
    assert set(g_t) == set(g_j)
    for k in g_j:
        want = np.asarray(g_j[k])
        scale = np.abs(want).max()
        assert scale > 0, f"{k}: the reference gradient is all zero"
        err = np.abs(g_t[k].numpy() - want).max() / scale
        assert err <= tol, f"{k}: {err:.3e} of the largest gradient"


@pytest.mark.parametrize("depth_key", ["pair", "packed"])
def test_frame_gradients_match_jax(depth_key):
    # the loss and scene of test_pallas_backward_matches_jnp_autodiff
    scene, z, w, h, opts = _scene("60@64x64")
    opts = dict(opts, depth_key=depth_key)
    loss_j, g_j, loss_t, g_t = _grads_both(scene, _camera(z, w, h), opts, 0.2)
    assert np.isclose(loss_t, loss_j, rtol=1e-5)
    _assert_grads_close(g_t, g_j)


def test_frame_gradients_match_jax_sh2():
    # view-dependent colour: sh_rest gets a gradient too; an off-axis camera
    scene, z, w, h, opts = _scene("60@64x64")
    scene["sh_rest"] = np.random.default_rng(8).normal(
        0, 0.3, (60, 45)).astype(np.float32)
    opts = dict(opts, sh_degree=2)
    loss_j, g_j, loss_t, g_t = _grads_both(
        scene, _camera(z, w, h, x=0.4, y=-0.3), opts, 0.2)
    assert np.isclose(loss_t, loss_j, rtol=1e-5)
    assert "sh_rest" in g_t and float(g_t["sh_rest"].abs().max()) > 0
    _assert_grads_close(g_t, g_j)


def test_duplicated_splat_sums_its_records_and_culled_records_get_zero():
    # one large splat over several tiles, stage by stage: its field
    # gradient is the sum over its records, and records the reachability
    # cull marked invalid (sorted past bounds[-1]) arrive with zero
    scene, z, w, h, opts = _scene("150@128x128")
    scene["scales"][0] = 0.6
    scene["opacities"][0] = 0.7
    scene["means"][0] = 0.0
    cfg = RenderConfig(**opts)
    args = _camera(z, w, h)
    params = params_from_numpy(scene, "cpu")
    view, vp = torch.from_numpy(args[0]), torch.from_numpy(args[1])
    table, prep = fastpath.splat_table(params, view, vp, *args[2:], cfg)
    fields = table[0].clone().requires_grad_(True)
    cum = ks.cumsum(prep["counts"])
    rec_f, rec_t, rec_d = kr.expand(fields, *table[1:], cum,
                                    **fastpath.expand_kwargs(150, w, h, cfg))
    # the records' own fields sorted (the frame sorts them by splat), so
    # that each record's cotangent can be read
    key = fastpath.record_key(cfg)
    sf, bounds, _ = rs.record_sort_plain(rec_f, rs.words_of(rec_t, rec_d, key),
                                         cfg.num_tiles, key)
    tiled, _, _ = fastpath.composite_sorted(
        sf, bounds, num_tiles=cfg.num_tiles,
        tile_ids=torch.arange(cfg.num_tiles, dtype=torch.int32), width=w,
        height=h, cfg=cfg)
    loss = ((tiled[..., :3] / 255.0 - 0.2) ** 2).mean() + 0.1 * tiled[..., 3].mean()
    g_rec, g_fields = torch.autograd.grad(loss, [rec_f, fields])

    lo, hi = 0, int(cum[0])
    assert hi - lo > 4                                   # really duplicated
    tiles_hit = rec_t[lo:hi][g_rec[:, lo:hi].abs().sum(dim=0) > 0]
    assert tiles_hit.unique().numel() > 1                # gradient from several tiles
    want = g_rec[:, lo:hi].sum(dim=1).numpy()
    np.testing.assert_allclose(g_fields[:, 0].numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    culled = rec_t == cfg.num_tiles
    total = int(cum[-1])
    assert culled[:total].any()
    assert not g_rec[:, culled].any()


def test_port_gradient_matches_finite_differences():
    # the directional check of tests/test_grad.py on the port: a random
    # direction over a whole tensor averages the pipeline's genuine steps
    # (alpha cutoff, tile boundaries, saturation) out
    w = h = 64
    scene = jax_ply.make_synthetic_scene(20, seed=5, extent=1.0)
    scene["opacities"] = np.clip(scene["opacities"], 0.3, 0.7)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    args = _camera(-4.0, w, h)
    cfg = RenderConfig(max_per_tile=512, chunk=64)

    def loss(p):
        img, _ = render_arrays(p, *args, cfg)
        return torch.mean((img[..., :3] - 0.1) ** 2)

    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    grads = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
    rng = np.random.default_rng(0)
    f64 = {k: np.asarray(v, np.float64) for k, v in scene.items()}
    for key, eps in [("colors", 1e-1), ("opacities", 1e-3), ("means", 1e-3),
                     ("scales", 1e-3), ("quats", 1e-3)]:
        g = grads[key].numpy().astype(np.float64)
        errs = []
        for _ in range(5):
            d = rng.normal(size=g.shape)
            d /= np.linalg.norm(d)
            want = float(np.sum(g * d))
            vals = []
            for sign in (1.0, -1.0):
                pert = dict(f64)
                pert[key] = f64[key] + sign * eps * d
                with torch.no_grad():
                    vals.append(float(loss(params_from_numpy(pert, "cpu"))))
            fd = (vals[0] - vals[1]) / (2 * eps)
            errs.append(abs(fd - want) / max(abs(want), abs(fd), 1e-6))
        assert np.sort(errs)[2] < 0.15, f"{key}: rel errs {np.sort(errs)}"


def test_backward_wrappers_run_plain_on_cpu_and_count_no_launch():
    before = (kc.composite.launches, kc.composite_bwd.launches,
              kr.expand.launches, kr.segsum.launches)
    scene, z, w, h, opts = _scene("60@64x64")
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    img, _ = render_arrays(p, *_camera(z, w, h), RenderConfig(**opts))
    img.sum().backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in p.values())
    assert before == (kc.composite.launches, kc.composite_bwd.launches,
                      kr.expand.launches, kr.segsum.launches)
    # neither on the CPU nor on a CUDA device: refused, never the plain version
    rec = torch.zeros((9, 8), device="meta")
    b = torch.zeros(3, dtype=torch.int32, device="meta")
    o = torch.zeros(2, dtype=torch.int32, device="meta")
    out = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kc.composite_bwd(rec, b, o, o, out, out, pw=2, ph=2, chunk=4,
                         alpha_min=0.1, alpha_max=0.99, thresh=0.01)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kr.segsum(rec, torch.zeros(3, dtype=torch.int32))


def test_header_edit_changes_the_build_digest(tmp_path):
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    assert any(h.name == "composite_common.cuh" for h in build.headers())
    (tmp_path / "a.cu").write_text("// kernel\n")
    (tmp_path / "a.cuh").write_text("// header 1\n")
    first = build.digest(tmp_path)
    (tmp_path / "a.cuh").write_text("// header 2\n")
    assert build.digest(tmp_path) != first
