"""The port's render path against the JAX fast path, plus its surfaces.

``render_arrays`` on the CPU (every kernel wrapper takes its plain PyTorch
version) against the JAX package's Pallas fast path in interpret mode, on
the scenes of ``tests/test_pallas_composite.py``: image within 1e-4 (the
ARCHITECTURE.md image contract) and every stats value exactly equal.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
)
from openglgaussiansplattingrenderer_tpu_torch.io import ply as port_ply
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
from openglgaussiansplattingrenderer_tpu_torch.render import (
    autotune_capacity,
    camera_args,
    quantize_capacity,
    render_arrays,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG_DIR = Path(port.__file__).parent
BASE = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
SINGLE = dict(max_per_tile=256, chunk=64, dup_capacity_factor=256.0)
SCENES = {
    "150@128x128": (lambda: jax_ply.make_synthetic_scene(150, seed=3, extent=2.0),
                    128, 128, -6.0, BASE),
    "400@128x64": (lambda: jax_ply.make_synthetic_scene(400, seed=9, extent=2.0),
                   128, 64, -6.0, BASE),
    "single@256x256": (jax_ply.single_splat_scene, 256, 256, -3.0, SINGLE),
}


def _render_both(name, depth_key):
    make, w, h, z, opts = SCENES[name]
    scene = {k: v for k, v in make().items() if k != "sh_rest"}
    a = jax_camera_args(JaxCamera(0.0, 0.0, z, width=w, height=h))
    img_j, st_j = jax_render(
        {k: jnp.asarray(v) for k, v in scene.items()}, jnp.asarray(a["view"]),
        jnp.asarray(a["vp"]), a["focal_x"], a["focal_y"], a["tan_fovx"],
        a["tan_fovy"], w, h, JaxConfig(depth_key=depth_key, **opts))
    img_t, st_t = render_arrays(
        params_from_numpy(scene, "cpu"), a["view"], a["vp"], a["focal_x"],
        a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h,
        port.RenderConfig(depth_key=depth_key, **opts))
    return np.asarray(img_j), st_j, img_t, st_t


@pytest.mark.parametrize("depth_key", ["pair", "packed"])
@pytest.mark.parametrize("name", list(SCENES))
def test_render_arrays_matches_jax_fast_path(name, depth_key):
    img_j, st_j, img_t, st_t = _render_both(name, depth_key)
    assert img_t.shape == img_j.shape and img_t.dtype == torch.float32
    assert img_j[..., 3].max() > 0.5
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)
    assert set(st_t) == set(st_j)
    for k in st_j:
        assert st_t[k].item() == np.asarray(st_j[k]).item(), k
    assert st_t["overflow"].item() == 0


def test_render_arrays_sh3_matches_jax_fast_path():
    # view-dependent colour (sh_degree 3) through both packages
    scene = jax_ply.make_synthetic_scene(150, seed=3, extent=2.0)
    scene["sh_rest"] = np.random.default_rng(8).normal(
        0, 0.3, scene["sh_rest"].shape).astype(np.float32)
    cam = JaxCamera(0.4, -0.3, -6.0, width=128, height=128)
    a = jax_camera_args(cam)
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], 128, 128)
    img_j, _ = jax_render({k: jnp.asarray(v) for k, v in scene.items()},
                          *args, JaxConfig(sh_degree=3, **BASE))
    img_t, _ = render_arrays(params_from_numpy(scene, "cpu"), *args,
                             port.RenderConfig(sh_degree=3, **BASE))
    img_0, _ = render_arrays(params_from_numpy(scene, "cpu"), *args,
                             port.RenderConfig(**BASE))
    assert np.abs(img_t.numpy() - img_0.numpy()).max() > 1e-2
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)


def test_splats_facade_renders_a_ply(tmp_path):
    scene = port_ply.make_synthetic_scene(150, seed=3, extent=2.0)
    path = str(tmp_path / "scene.ply")
    port_ply.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                      scene["opacities"], scene["colors"])
    cfg = port.RenderConfig(**BASE)
    s = port.Splats(path, 128, 128, cfg, device="cpu")
    assert s.num_splats == 150
    cam = port.Camera(0.0, 0.0, -6.0, width=128, height=128)
    img = s.render_camera(cam)
    assert img.shape == (128, 128, 4) and img[..., 3].max() > 0.5
    assert s.last_stats["overflow"] == 0 and s.last_stats["num_splats"] == 150
    # gpu_render takes the reference's argument order and agrees
    a = camera_args(cam)
    img2 = s.gpu_render(a["view"], 128, 128, a["focal_x"], a["focal_y"],
                        a["tan_fovx"], a["tan_fovy"], a["vp"])
    np.testing.assert_array_equal(img2, img)
    # the loaded scene renders like the in-memory one (PLY round trip)
    ref, _ = render_arrays(params_from_numpy(
        {k: v for k, v in scene.items() if k != "sh_rest"}, "cpu"),
        a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
        a["tan_fovy"], 128, 128, cfg)
    np.testing.assert_allclose(img, ref.numpy(), atol=1e-4)
    s.autotune_capacity(cam)
    assert s.cfg.capacity_records >= int(s.last_stats["num_records"])
    s.render_camera(cam)
    assert s.last_stats["overflow"] == 0
    s.display(str(tmp_path / "out.png"))
    assert (tmp_path / "out.png").stat().st_size > 0
    # inference=True is the q16 configuration (tests/test_torch_q16.py)
    fast = port.Splats(path, 128, 128, cfg, device="cpu", inference=True)
    assert fast.cfg.sort_payload == "q16" and fast.cfg.depth_key == "packed"


def test_ply_helpers_match_jax_bit_for_bit(tmp_path):
    for make_j, make_t in (
            (lambda: jax_ply.make_synthetic_scene(64, seed=5),
             lambda: port_ply.make_synthetic_scene(64, seed=5)),
            (lambda: jax_ply.make_clustered_scene(64, seed=5),
             lambda: port_ply.make_clustered_scene(64, seed=5)),
            (jax_ply.single_splat_scene, port_ply.single_splat_scene)):
        a, b = make_j(), make_t()
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    sc = port_ply.make_synthetic_scene(20, seed=1)
    path = str(tmp_path / "s.ply")
    port_ply.save_ply(path, sc["means"], sc["quats"], sc["scales"],
                      sc["opacities"], sc["colors"], sc["sh_rest"])
    # the numpy parsers (load_splats reads through the native loader where
    # it builds: tests/test_torch_native_loader.py)
    got = port_ply.activate(port_ply.load_ply(path))
    want = jax_ply.activate(jax_ply.load_ply(path))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_params_round_trip():
    scene = port_ply.make_synthetic_scene(30, seed=2)
    t = params_from_numpy(scene, "cpu")
    assert all(v.dtype == torch.float32 for v in t.values())
    back = params_to_numpy(t)
    for k in scene:
        np.testing.assert_array_equal(back[k], scene[k])
    with pytest.raises(KeyError):
        params_from_numpy({"mean": scene["means"]}, "cpu")


def test_autotune_and_quantize_capacity_match_jax():
    from openglgaussiansplattingrenderer_tpu.render import (
        autotune_capacity as jax_autotune,
        quantize_capacity as jax_quantize,
    )

    for r in (0, 1000, 5000, 123457, 6_000_000):
        assert quantize_capacity(r) == jax_quantize(r)
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(150, seed=3).items()
             if k != "sh_rest"}
    a = jax_camera_args(JaxCamera(0.0, 0.0, -6.0, width=128, height=128))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], 128, 128)
    want = jax_autotune(
        {k: jnp.asarray(v) for k, v in scene.items()}, *args, JaxConfig(**BASE))
    got = autotune_capacity(params_from_numpy(scene, "cpu"), *args,
                            port.RenderConfig(**BASE))
    assert got.capacity_records == want.capacity_records


@pytest.mark.parametrize("opts,error", [
    # the oracle pipeline renders as the JAX package's does (error None);
    # the other three do not compose, and are refused with the JAX
    # package's ValueErrors
    pytest.param(dict(use_pallas=False), None, id="opts0"),
    pytest.param(dict(record_sort="radix"), ValueError, id="opts1"),
    pytest.param(dict(record_sort="radix", depth_key="reference"), ValueError,
                 id="opts2"),
    pytest.param(dict(sort_payload="q16", depth_key="packed",
                      hoist_depth_sort=True), ValueError, id="opts3")])
def test_unported_modes_raise(opts, error):
    scene = {k: v for k, v in port_ply.single_splat_scene().items()
             if k != "sh_rest"}
    a = camera_args(port.Camera(0.0, 0.0, -3.0, width=64, height=64))
    args = (params_from_numpy(scene, "cpu"), a["view"], a["vp"], a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], 64, 64)
    if error is None:
        img_t, st_t = render_arrays(*args, port.RenderConfig(**opts, **SINGLE))
        img_j, st_j = jax_render({k: jnp.asarray(v) for k, v in scene.items()},
                                 *args[1:], JaxConfig(**opts, **SINGLE))
        assert np.asarray(img_j)[..., 3].max() > 0.5
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
        assert {k: v.item() for k, v in st_t.items()} == {
            k: np.asarray(v).item() for k, v in st_j.items()}
        return
    with pytest.raises(error):
        render_arrays(*args, port.RenderConfig(**opts))
    if error is ValueError:
        # the JAX package refuses the same configuration the same way
        with pytest.raises(ValueError):
            jax_render({k: jnp.asarray(v) for k, v in scene.items()}, *args[1:],
                       JaxConfig(**opts))


SORT_SCENE = dict(grid_x=2, grid_y=2, chunk=128, capacity_records=2048)
SINGLE_KEY = {
    # name -> (the port's options, the JAX options of the frame it must equal)
    "hoisted": (dict(hoist_depth_sort=True), dict(hoist_depth_sort=True)),
    "hoisted+radix": (dict(hoist_depth_sort=True, record_sort="radix"),
                      dict(hoist_depth_sort=True)),
    # the JAX package's own slow test proves its radix frame bit-identical to
    # its lax.sort frame; its interpret-mode radix render is too slow here
    "packed+radix": (dict(depth_key="packed", record_sort="radix"),
                     dict(depth_key="packed")),
}


def _sort_scene():
    """The 600-splat 64x64 scene of tests/test_radix_sort.py."""
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(
        600, seed=11, extent=2.0).items() if k != "sh_rest"}
    a = jax_camera_args(JaxCamera(0.0, 0.0, -6.0, width=64, height=64))
    return scene, (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
                   a["tan_fovy"], 64, 64)


def _jax_frame(scene, args, **opts):
    img, stats = jax_render({k: jnp.asarray(v) for k, v in scene.items()},
                            jnp.asarray(args[0]), jnp.asarray(args[1]), *args[2:],
                            JaxConfig(**opts))
    return np.asarray(img), {k: np.asarray(v).item() for k, v in stats.items()}


@pytest.mark.parametrize("name", list(SINGLE_KEY))
def test_single_key_sort_frames_match_jax(name):
    # image within 1e-4 (the ARCHITECTURE.md image contract), stats equal
    port_opts, jax_opts = SINGLE_KEY[name]
    scene, args = _sort_scene()
    img_j, st_j = _jax_frame(scene, args, **SORT_SCENE, **jax_opts)
    img_t, st_t = render_arrays(params_from_numpy(scene, "cpu"), *args,
                                port.RenderConfig(**SORT_SCENE, **port_opts))
    assert img_j[..., 3].max() > 0.5 and st_j["overflow"] == 0
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)
    assert {k: v.item() for k, v in st_t.items()} == st_j
    # the sort engine does not show in the port's frame: both are stable
    img_lax, _ = render_arrays(
        params_from_numpy(scene, "cpu"), *args, port.RenderConfig(
            **SORT_SCENE, **{k: v for k, v in port_opts.items() if k != "record_sort"}))
    assert torch.equal(img_t, img_lax)


@pytest.mark.parametrize("record_sort", ["lax", "radix"])
def test_hoisted_overflow_drops_the_farthest_records(record_sort):
    # a capacity below the record count: the hoisted frame loses the farthest
    # splats' records, as in JAX, where the default path loses the last in
    # splat order
    scene, args = _sort_scene()
    scene["scales"] = scene["scales"] * 2.0          # 5,023 records at 16x16 tiles
    small = dict(chunk=128, capacity_records=4096)
    img_j, st_j = _jax_frame(scene, args, **small, hoist_depth_sort=True)
    params = params_from_numpy(scene, "cpu")
    img_t, st_t = render_arrays(params, *args, port.RenderConfig(
        **small, hoist_depth_sort=True, record_sort=record_sort))
    assert st_j["overflow"] > 0
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)
    assert {k: v.item() for k, v in st_t.items()} == st_j
    img_p, st_p = render_arrays(params, *args, port.RenderConfig(**small))
    assert st_p["overflow"].item() == st_j["overflow"]
    assert float((img_p - img_t).abs().max()) > 1e-2


@pytest.mark.parametrize("record_sort", ["lax", "radix"])
def test_hoisted_frame_gradients_match_jax_grad(record_sort):
    # every parameter tensor within 5e-3 of its largest gradient (the
    # ARCHITECTURE.md gradient contract); the N-sized depth sort un-permutes
    # the table's cotangents
    import jax

    scene, args = _sort_scene()
    opts = dict(SORT_SCENE, hoist_depth_sort=True)

    def loss_j(p):
        img, _ = jax_render(p, jnp.asarray(args[0]), jnp.asarray(args[1]),
                            *args[2:], JaxConfig(**opts))
        return jnp.mean((img[..., :3] - 0.2) ** 2) + 0.1 * jnp.mean(img[..., 3])

    want = jax.grad(loss_j)({k: jnp.asarray(v) for k, v in scene.items()})
    p = {k: v.requires_grad_(True)
         for k, v in params_from_numpy(scene, "cpu").items()}
    img, _ = render_arrays(p, *args, port.RenderConfig(**opts, record_sort=record_sort))
    loss = ((img[..., :3] - 0.2) ** 2).mean() + 0.1 * img[..., 3].mean()
    got = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for k, w in want.items():
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(got[k].numpy() - w).max() <= 5e-3 * scale, k


def test_port_never_imports_jax():
    code = ("import sys, openglgaussiansplattingrenderer_tpu_torch as p, "
            "openglgaussiansplattingrenderer_tpu_torch.ops.fastpath, "
            "openglgaussiansplattingrenderer_tpu_torch.ops.kernels.build, "
            "openglgaussiansplattingrenderer_tpu_torch.train.trainer, "
            "openglgaussiansplattingrenderer_tpu_torch.train.losses, "
            "openglgaussiansplattingrenderer_tpu_torch.convert, "
            "openglgaussiansplattingrenderer_tpu_torch.ops.kernels.radix_sort, "
            "openglgaussiansplattingrenderer_tpu_torch.probes.bucketer_probe, "
            "openglgaussiansplattingrenderer_tpu_torch.probes.cache_key_probe, "
            "openglgaussiansplattingrenderer_tpu_torch.golden, "
            "openglgaussiansplattingrenderer_tpu_torch.io.native, "
            "openglgaussiansplattingrenderer_tpu_torch.ops.binning, "
            "openglgaussiansplattingrenderer_tpu_torch.ops.sorting, "
            "openglgaussiansplattingrenderer_tpu_torch.train.densify, "
            "openglgaussiansplattingrenderer_tpu_torch.io.dataset, "
            "openglgaussiansplattingrenderer_tpu_torch.io.colmap, "
            "openglgaussiansplattingrenderer_tpu_torch.utils.timing, "
            "openglgaussiansplattingrenderer_tpu_torch.viewer.offline, "
            "openglgaussiansplattingrenderer_tpu_torch.viewer.interactive, "
            "openglgaussiansplattingrenderer_tpu_torch.parallel.sharded, "
            "openglgaussiansplattingrenderer_tpu_torch.parallel.fast_sharded, "
            "openglgaussiansplattingrenderer_tpu_torch.parallel.data_parallel, "
            "openglgaussiansplattingrenderer_tpu_torch.parallel.mesh2d, "
            "openglgaussiansplattingrenderer_tpu_torch.parallel.multihost, "
            "openglgaussiansplattingrenderer_tpu_torch.dryrun, "
            "importlib.util as u; "
            "[s.loader.exec_module(u.module_from_spec(s)) for s in ("
            "u.spec_from_file_location(n, f'scripts/{n}.py') for n in ("
            "'torch_train_cli', 'torch_render_cli', 'torch_viewer_fps_bench', "
            "'torch_scaling_report', 'torch_gate_divergence'))]; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    repo = str(PKG_DIR.parent)
    env = {**os.environ, "PYTHONPATH": repo}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=env, timeout=120)
    # no import of jax, nor of the JAX package (which imports jax)
    pat = re.compile(r"^\s*(import|from)\s+(jax|openglgaussiansplattingrenderer_tpu)\b"
                     r"(?!_torch)", re.M)
    files = sorted(PKG_DIR.rglob("*.py"))
    assert len(files) > 10
    # and neither do the scripts of the port that run on the card
    files += [PKG_DIR.parent / "chip_smoke.py",
              PKG_DIR.parent / "scripts" / "torch_gate_divergence.py",
              PKG_DIR.parent / "scripts" / "torch_train_cli.py",
              PKG_DIR.parent / "scripts" / "torch_render_cli.py",
              PKG_DIR.parent / "scripts" / "torch_viewer_fps_bench.py",
              PKG_DIR.parent / "scripts" / "torch_scaling_report.py",
              PKG_DIR.parent / "tests" / "_torch_multihost_worker.py"]
    for f in files:
        assert not pat.search(f.read_text()), f


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    # no fallback: a missing compiler is an error, never the plain version
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.load_library.cache_clear()
    try:
        with pytest.raises(build.KernelBuildError, match="nvcc"):
            build.load_library()
    finally:
        build.load_library.cache_clear()


def test_wrappers_take_the_plain_version_only_on_cpu():
    # a tensor that is neither on the CPU nor on a CUDA device is refused
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ks.cumsum(meta)
    rec = torch.zeros((9, 8), device="meta")
    b = torch.zeros(3, dtype=torch.int32, device="meta")
    o = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kc.composite(rec, b, o, o, pw=2, ph=2, chunk=4, alpha_min=0.1,
                     alpha_max=0.99, thresh=0.01)
    with pytest.raises(TypeError):
        ks.cumsum(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kr.expand(torch.zeros((9, 3)), torch.zeros((3, 2), dtype=torch.int32),
                  torch.zeros((3, 2), dtype=torch.int32), torch.zeros(3),
                  torch.zeros(4, dtype=torch.int32), capacity=8, gx=2,
                  num_tiles=4, pw=2, ph=2, alpha_min=0.1)
    cfg = port.RenderConfig()
    cam = (2.0, 2.0, -0.5, -0.5, 8, 8, cfg)
    eye = torch.eye(4, device="meta")
    table_in = {k: None for k in kt.INPUTS}
    table_in.update(means=torch.zeros((3, 3), device="meta"),
                    cov6=torch.zeros((3, 6), device="meta"),
                    opacities=torch.zeros(3, device="meta"),
                    colors=torch.zeros((3, 3), device="meta"))
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kt.splat_table_fwd(table_in, eye, eye, cam)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kt.splat_table_bwd(table_in, eye, eye, cam, torch.zeros((9, 3), device="meta"))
    counters = (ks.cumsum, kr.expand, kc.composite, kt.splat_table, kt.splat_table_bwd)
    before = [f.launches for f in counters]
    ks.cumsum(torch.ones(5, dtype=torch.int32))
    cpu_in = {k: None if v is None else torch.rand(v.shape) for k, v in table_in.items()}
    kt.splat_table_bwd(cpu_in, torch.eye(4), torch.eye(4), cam,
                       kt.splat_table_fwd(cpu_in, torch.eye(4), torch.eye(4), cam)[0])
    assert [f.launches for f in counters] == before


def test_config_and_camera_copies_match_jax():
    cfg_j = JaxConfig.for_resolution(1024, 512, tile_px=32, chunk=256)
    cfg_t = port.RenderConfig.for_resolution(1024, 512, tile_px=32, chunk=256)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    assert cfg_t.capacity(1000) == cfg_j.capacity(1000)
    cj, ct = JaxCamera(1, 2, -3), port.Camera(1, 2, -3)
    for c in (cj, ct):
        c.rotate_right(20.0)
    np.testing.assert_array_equal(ct.get_vp_matrix(), cj.get_vp_matrix())
    aj, at = jax_camera_args(cj), camera_args(ct)
    for k in aj:
        np.testing.assert_array_equal(at[k], aj[k])
