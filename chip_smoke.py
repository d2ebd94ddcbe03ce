#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``openglgaussiansplattingrenderer_tpu_torch/
csrc`` (nvcc, at first use), then:

1. prints the card, its power limit, the PyTorch version and the build time;
2. holds each of the nine kernels against its plain PyTorch version on the
   card and times both (CUDA events, median), beside the least time the
   card could take for the same work (``bound_ms``) and, where one PyTorch
   call computes the same function, that call's time (``library_ms``):
   prefix sum and expansion on the flagship frame, bit-equal; the prefix
   sum again at 67,108,864 values, where the device and not the host's
   dispatch sets the time, and on one value, as the host's cost of a launch;
   the radix sort's histogram and scatter on the frame's own 6.29M packed
   keys, every pass exact, the scatter's stored bytes over its time a pass,
   the offset table between them (one launch of the prefix-sum kernel)
   exact against its plain version, and the whole sort against
   ``torch.sort(stable=True)``
   element for element; the bucketing-level probe kernel exact on 64
   chunks and timed through its probe at 6,291,456 records, and the
   build-cache probe with its kernel, timed at (8, 128) and at 1,000,003
   values (these two run last, behind every time of the main paths);
   segment sum
   on the flagship frame's shapes with a seeded cotangent; compositor
   forward (image max abs diff <= 5e-3 with <= 10 px above 1e-3) and
   backward (per row within a stated share of the row's largest gradient,
   columns past the last tile zero) on the uniform flagship frame's sorted
   records and on the 10k-splat gate scene, with a seeded cotangent and
   each backward fed its own forward's output;
3. drives the render path through ``render_arrays`` at the reference's
   operating point (3,616,103 splats at 1024x512, uniform and clustered
   scenes), with every kernel launch counter reset just before and read
   just after; checks zero overflow, a finite image with coverage, every
   forward kernel launched, the uniform frame against the all-plain
   pipeline, and a small frame against the port's CPU path; then the
   uniform frame through the single-key record sorts (packed + radix and
   hoisted + radix bit-equal to their ``torch.sort`` frames, hoisted, and
   the q16 inference mode within 0.01 of the f32 frame), each with its own
   launch counts, and q16 against f32 on a 512-splat scene within 2e-3;
4. prints each flagship scene's per-stage device times of one forward +
   backward (CUDA events);
5. drives the training path: five Adam steps of ``make_train_step`` (L1 +
   D-SSIM, per-splat densification statistic) on the uniform flagship scene
   with perturbed colours against its clean render, counters reset just
   before and read just after; checks finite gradients, zero overflow, a
   falling loss and the training path's five kernels launched; times forward + backward
   and the whole step;
6. times one forward + backward of the clustered flagship and of the
   1,000,000-splat 1920x1080 scene, and holds a small frame's gradients
   on the card against the port's CPU path;
7. prints a JSON line of per-kernel results and, last, the device line.

Every check raises on failure; the exit code is nonzero and no result line
is printed. There is no fallback: without CUDA the script exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLAG_SPLATS = 3_616_103            # the reference's bike-big.ply
FLAG_W, FLAG_H = 1024, 512         # the reference's default resolution
GATE_SPLATS, GATE_W, GATE_H = 10_000, 512, 512
MSPLATS, MSPLATS_W, MSPLATS_H, MSPLATS_CHUNK = 1_000_000, 1920, 1080, 128
REPS = 5
TRAIN_STEPS = 5
GATE_MAX_ABS, GATE_MAX_PX = 5e-3, 10
# Compositor backward against its plain version, of the row's largest plain
# gradient. Sequential and scanned transmittance round differently, so a
# record at the saturation edge could flip and move a row by up to ~5e-3;
# none does on the uniform flagship frame's records (up to 48,947 a tile,
# 192 batches of ``chunk``: measured 4.6e-6, no record beyond 1e-3) nor on
# the gate scene (1.4e-6), so the limit is held more than an order above
# what the runs show, not at 5e-3.
BWD_ROW_TOL = 1e-4
SEGSUM_ROW_TOL = 1e-5              # of the row's largest plain sum
GRAD_REL_TOL = 5e-3                # card vs CPU path, per parameter tensor
# q16 against the f32 frame: the reference's own CPU-vs-GPU tolerance at
# the flagship (saturation flips reach a few 1e-3 there), and the budget of
# the JAX package's q16 test on its 512-splat 64x64 scene
Q16_FLAG_TOL, Q16_SMALL_TOL = 1e-2, 2e-3
BUCKET_C, BUCKET_K = 6 * 1024 * 1024, 32   # the bucketing probe's own size
# a size at which the device and not the host's dispatch sets a small
# kernel's time: 256 MB in, 256 MB out for the prefix sum
LARGE_SCAN = 64 * 1024 * 1024
LARGE_AFFINE = 1_000_003

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and float32 rate outside the tensor cores (a multiply-add counts 2).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Float operations a (pixel, record) pair costs the compositor, counted
# from the kernels' arithmetic with expf as one operation: every visited
# pair pays u, v, the power, expf, the opacity product and the clamp (12);
# a blended pair adds the weight, three colour multiply-adds and the
# transmittance update in the forward (9), and in the backward e, D, the
# colour sums, dabar, dpower, dx, dy, the six moment sums and the
# transmittance update (33).
FWD_FLOP_VISITED, FWD_FLOP_BLENDED = 12, 9
BWD_FLOP_VISITED, BWD_FLOP_BLENDED = 12, 33

PKG = "openglgaussiansplattingrenderer_tpu_torch"
TPU_PKG = "openglgaussiansplattingrenderer_tpu"
KERNELS = {
    "cumsum": (f"{PKG}/csrc/scan.cu", f"{TPU_PKG}/ops/pallas/scan.py:37"),
    "expand": (f"{PKG}/csrc/expand.cu", f"{TPU_PKG}/ops/pallas/records.py:405"),
    "segsum": (f"{PKG}/csrc/segsum.cu", f"{TPU_PKG}/ops/pallas/records.py:536"),
    "composite": (f"{PKG}/csrc/composite.cu",
                  f"{TPU_PKG}/ops/pallas/composite.py:237"),
    "composite_bwd": (f"{PKG}/csrc/composite_bwd.cu",
                      f"{TPU_PKG}/ops/pallas/composite.py:385"),
    "radix_hist": (f"{PKG}/csrc/radix_sort.cu",
                   f"{TPU_PKG}/ops/pallas/radix_sort.py:76"),
    "radix_scatter": (f"{PKG}/csrc/radix_sort.cu",
                      f"{TPU_PKG}/ops/pallas/radix_sort.py:133"),
    "bucketer_level": (f"{PKG}/csrc/bucketer_probe.cu", "scripts/bucketer_probe.py:68"),
    "probe_affine": (f"{PKG}/csrc/probe_affine.cu", "scripts/cache_key_probe.py:34"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_running(fn, calls: int = 40, reps: int = REPS) -> float:
    """Median device time of one call of ``fn`` in ms when ``calls`` of them
    are enqueued back to back between two CUDA events: the host's dispatch
    hides behind the device's work unless it is the longer of the two."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, reps: int = 200) -> float:
    """Median host time of one call of ``fn`` in microseconds, the device
    not waited for: what the caller's thread pays to enqueue it."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def image_diff(a, b):
    """(max abs diff, pixels whose max channel diff exceeds 1e-3)."""
    d = (a - b).abs()
    return float(d.max()), int((d.amax(dim=-1) > 1e-3).sum())


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def kernel_wrappers():
    """name -> wrapper holding the launch counter, in KERNELS' order."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
    from openglgaussiansplattingrenderer_tpu_torch.probes import bucketer_probe, cache_key_probe

    return {"cumsum": ks.cumsum, "expand": kr.expand, "segsum": kr.segsum,
            "composite": kc.composite, "composite_bwd": kc.composite_bwd,
            "radix_hist": rx.radix_hist, "radix_scatter": rx.radix_scatter,
            "bucketer_level": bucketer_probe.bucketer_level,
            "probe_affine": cache_key_probe.probe_affine}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


class Frame:
    """One scene and camera, with the port's frame stages exposed so the
    kernels can be fed the render path's own inputs."""

    def __init__(self, scene, cam, cfg, device):
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
        from openglgaussiansplattingrenderer_tpu_torch.render import camera_args

        self.params = params_from_numpy(
            {k: v for k, v in scene.items() if k != "sh_rest"}, device)
        a = camera_args(cam)
        mat = {k: torch.as_tensor(a[k], device=device) for k in ("view", "vp")}
        self.args = (mat["view"], mat["vp"], a["focal_x"], a["focal_y"],
                     a["tan_fovx"], a["tan_fovy"], cam.width, cam.height)
        self.cfg = cfg

    @property
    def size(self):
        return self.args[6], self.args[7]

    def with_cfg(self, cfg):
        import copy

        f = copy.copy(self)
        f.cfg = cfg
        return f

    def render(self):
        from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays

        return render_arrays(self.params, *self.args, self.cfg)

    def grads(self, loss):
        """One forward + backward: ({name: gradient}, stats) of
        ``loss(image)`` with respect to every parameter tensor."""
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays

        p = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        img, stats = render_arrays(p, *self.args, self.cfg)
        return dict(zip(p, torch.autograd.grad(loss(img), list(p.values())))), stats

    def sorted_records(self):
        """(sorted fields, bounds) through the kernels, as the frame makes them."""
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

        table, counts, ekw = self.table()
        rec = kr.expand(*table, ks.cumsum(counts), **ekw)
        return fastpath.sort_records(*rec, *self.size, self.cfg)

    def table(self):
        """((fields, tile_min, tile_ext, depth), counts, expand kwargs)."""
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

        table, prep = fastpath.splat_table(self.params, *self.args, self.cfg)
        n = self.params["means"].shape[0]
        return table, prep["counts"], fastpath.expand_kwargs(n, *self.size, self.cfg)

    def composite_inputs(self, sf):
        """(ox, oy, composite kwargs) for all tiles of the frame."""
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc

        kw = fastpath.composite_kwargs(*self.size, self.cfg)
        t = torch.arange(self.cfg.num_tiles, dtype=torch.int32, device=sf.device)
        ox, oy = kc.tile_origins(t, kw["pw"], kw["ph"], self.cfg.grid_x)
        return ox, oy, kw

    def image(self, tiled):
        from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import assemble_image

        return assemble_image(tiled[:, :, :3], tiled[:, :, 3], *self.size, self.cfg)

    def plain_render(self):
        """The whole frame through the plain versions of every kernel."""
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

        table, counts, ekw = self.table()
        rec = kr.expand_plain(*table, ks.cumsum_plain(counts), **ekw)
        sf, bounds = fastpath.sort_records(*rec, *self.size, self.cfg)
        ox, oy, ckw = self.composite_inputs(sf)
        return self.image(kc.composite_plain(sf, bounds, ox, oy, **ckw))


def check_scan_and_expand(frame, results):
    """Kernels 1, 2 and 3 at the flagship frame's shapes."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    table, counts, kw = frame.table()
    n, cap = counts.numel(), kw["capacity"]
    cum = ks.cumsum(counts)
    cum_p = ks.cumsum_plain(counts)
    assert torch.equal(cum, cum_p), "cumsum kernel differs from torch.cumsum"
    err = float((cum - cum_p).abs().max())
    ms, pms = cuda_ms(lambda: ks.cumsum(counts)), cuda_ms(lambda: ks.cumsum_plain(counts))
    lms = cuda_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32))
    run_ms = cuda_ms_running(lambda: ks.cumsum(counts))
    run_lms = cuda_ms_running(lambda: torch.cumsum(counts, 0, dtype=torch.int32))
    # the host's cost of a launch: the wrapper on one value, where the device
    # has nothing to do. Rows under ~0.05 ms are to be read against it.
    one = counts[:1].contiguous()
    one_ms = cuda_ms(lambda: ks.cumsum(one), reps=21)
    one_lib_ms = cuda_ms(lambda: torch.cumsum(one, 0, dtype=torch.int32), reps=21)
    one_us = host_us(lambda: ks.cumsum(one))
    one_lib_us = host_us(lambda: torch.cumsum(one, 0, dtype=torch.int32))
    log(f"[2] host cost of a launch, one value: cumsum wrapper {one_us:.1f} us on "
        f"the host's clock, {one_ms:.4f} ms between CUDA events; torch.cumsum "
        f"{one_lib_us:.1f} us, {one_lib_ms:.4f} ms")
    # and at a size the device sets the time of
    gen = torch.Generator(device=counts.device).manual_seed(11)
    big = torch.randint(0, 100, (LARGE_SCAN,), generator=gen, device=counts.device,
                        dtype=torch.int32)
    assert torch.equal(ks.cumsum(big), torch.cumsum(big, 0, dtype=torch.int32)), (
        "cumsum kernel differs from torch.cumsum at the large size")
    large = dict(n=LARGE_SCAN, ms=cuda_ms(lambda: ks.cumsum(big)),
                 library_ms=cuda_ms(lambda: torch.cumsum(big, 0, dtype=torch.int32)),
                 **bound(2 * 4 * LARGE_SCAN, LARGE_SCAN))
    del big
    # each count read once, each sum written once; one add a value
    results["cumsum"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                             **bound(2 * 4 * n, n), large=large,
                             running_ms=run_ms, library_running_ms=run_lms,
                             one_value_ms=one_ms, one_value_host_us=one_us,
                             library_one_value_ms=one_lib_ms,
                             library_one_value_host_us=one_lib_us)
    log(f"[2] cumsum  n={n} exact; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"torch.cumsum {lms:.4f} ms, bound {results['cumsum']['bound_ms']:.4f} ms; "
        f"40 calls back to back {run_ms:.4f} ms a call, torch.cumsum {run_lms:.4f}; "
        f"n={LARGE_SCAN} exact; kernel {large['ms']:.4f} ms, torch.cumsum "
        f"{large['library_ms']:.4f} ms, bound {large['bound_ms']:.4f} ms")

    got = kr.expand(*table, cum, **kw)
    ref = kr.expand_plain(*table, cum, **kw)
    for name, a, b in zip(("fields", "tile", "depth"), got, ref):
        assert torch.equal(a, b), f"expand {name} differ from the plain version"
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
    ms = cuda_ms(lambda: kr.expand(*table, cum, **kw))
    pms = cuda_ms(lambda: kr.expand_plain(*table, cum, **kw))
    total = min(int(cum[-1]), cap)
    # written: 9 fields + tile + depth a record (44 B); read: 9 fields, the
    # tile rect (4 ints), depth and the prefix sum a splat (60 B). The cull
    # costs about 60 float operations a record below total.
    results["expand"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                             **bound(44 * cap + 60 * n, 60 * total))
    log(f"[2] expand  C={cap} records (total {total}) bit-equal; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{results['expand']['bound_ms']:.4f} ms")

    gen = torch.Generator(device=cum.device).manual_seed(5)
    g = torch.randn((kr.NUM_FIELDS, cap), generator=gen, device=cum.device)
    got = kr.segsum(g, cum)
    ref = kr.segsum_plain(g, cum)
    scale = ref.abs().amax(dim=1).clamp_min(1e-30)
    rel = float(((got - ref).abs().amax(dim=1) / scale).max())
    assert rel <= SEGSUM_ROW_TOL, f"segsum vs plain: {rel:.3e} of the row's scale"
    empty = torch.nonzero(counts == 0).squeeze(1)
    assert empty.numel() and not got[:, empty].any(), "segsum: empty splats not zero"
    ms = cuda_ms(lambda: kr.segsum(g, cum))
    pms = cuda_ms(lambda: kr.segsum_plain(g, cum))
    ids = torch.searchsorted(cum, torch.arange(total, dtype=torch.int32,
                                               device=cum.device), right=True)
    lib_out = torch.zeros((kr.NUM_FIELDS, n), device=cum.device)
    lms = cuda_ms(lambda: lib_out.zero_().index_add_(1, ids, g[:, :total]))
    # read: 36 B a record below total and the prefix sum; written: 36 B a
    # splat; one add a value read
    results["segsum"] = dict(
        max_abs_err=float((got - ref).abs().max()), max_row_rel_err=rel, ms=ms,
        plain_ms=pms, library_ms=lms, **bound(36 * total + 40 * n, 9 * total))
    log(f"[2] segsum  C={cap} -> n={n}: {rel:.3e} of the row's scale; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, index_add_ {lms:.4f} ms, bound "
        f"{results['segsum']['bound_ms']:.4f} ms")


def check_radix(frame, results):
    """Kernels 6 and 7 on the uniform flagship frame's own packed keys: every
    pass of the sort against the plain versions, exactly, and the whole
    sort against torch.sort(stable=True), element for element."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    table, counts, ekw = frame.table()
    _, rec_t, rec_d = kr.expand(*table, ks.cumsum(counts), **ekw)
    del table
    key64 = kr.packed_key(rec_t, rec_d)         # as the torch.sort path holds it
    keys = kr.u32_bits(key64)                   # as the radix path holds it
    c, dev = keys.numel(), keys.device
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    bits, passes = rx.BITS, 32 // rx.BITS

    def same(got, ref, what):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
            f"radix_scatter {what}: differs from the plain version")

    k, v = keys, idx[None, :].contiguous()
    hist_ms, scat_ms, offs_ms = [], [], []
    for p in range(passes):
        shift = p * bits
        cnt = rx.radix_hist(k, shift)
        assert torch.equal(cnt, rx.radix_hist_plain(k, shift)), (
            f"radix_hist pass {p}: differs from the plain version")
        offs = rx._prefix_offsets(cnt)
        assert torch.equal(offs, rx._prefix_offsets_plain(cnt)), (
            f"_prefix_offsets pass {p}: differs from the plain version")
        got = rx.radix_scatter(k, v, offs, shift)
        same(got, rx.radix_scatter_plain(k, v, offs, shift), f"pass {p}")
        hist_ms.append(cuda_ms(lambda: rx.radix_hist(k, shift)))
        offs_ms.append(cuda_ms(lambda: rx._prefix_offsets(cnt)))
        scat_ms.append(cuda_ms(lambda: rx.radix_scatter(k, v, offs, shift)))
        if p == 0:
            hist_plain = cuda_ms(lambda: rx.radix_hist_plain(k, shift))
            at = ((torch.arange(c, device=dev) // rx.CHUNK << bits)
                  + (k & ((1 << bits) - 1)))
            bincount = cuda_ms(lambda: torch.bincount(at, minlength=cnt.numel()))
            scat_plain = cuda_ms(lambda: rx.radix_scatter_plain(k, v, offs, shift))
            offs_plain = cuda_ms(lambda: rx._prefix_offsets_plain(cnt))
            # nine payload rows, and the 4-bit digit of the JAX package
            gen = torch.Generator(device=dev).manual_seed(8)
            v9 = torch.randn((9, c), generator=gen, device=dev).view(torch.int32)
            same(rx.radix_scatter(k, v9, offs, shift),
                 rx.radix_scatter_plain(k, v9, offs, shift), "nine rows")
            nine_ms = cuda_ms(lambda: rx.radix_scatter(k, v9, offs, shift))
            del v9, at
            cnt4 = rx.radix_hist(k, 0, 4)
            assert torch.equal(cnt4, rx.radix_hist_plain(k, 0, 4)), "radix_hist, 4 bits"
            offs4 = rx._prefix_offsets(cnt4)
            assert torch.equal(offs4, rx._prefix_offsets_plain(cnt4)), (
                "_prefix_offsets, 4 bits")
            same(rx.radix_scatter(k, v, offs4, 0, 4),
                 rx.radix_scatter_plain(k, v, offs4, 0, 4), "4 bits")
        k, v = got
    rk, ri = torch.sort(key64, stable=True)
    assert torch.equal(kr.u32_values(k), rk) and torch.equal(v[0].to(torch.int64), ri), (
        "the radix passes differ from torch.sort(stable=True)")
    sk, (si,) = rx.radix_sort(keys, (idx,), 32)
    assert torch.equal(sk, k) and torch.equal(si, v[0]), (
        "radix_sort differs from its passes")
    whole = cuda_ms(lambda: rx.radix_sort(keys, (idx,), 32))
    sort64 = cuda_ms(lambda: torch.sort(key64, stable=True))
    # the hoisted path's key: the tile id alone, which int32 holds
    kb = max(1, int(frame.cfg.num_tiles).bit_length())
    st, (sti,) = rx.radix_sort(rec_t, (idx,), kb)
    rt, rti = torch.sort(rec_t, stable=True)
    assert torch.equal(st, rt) and torch.equal(sti.to(torch.int64), rti), (
        "radix_sort of the tile ids differs from torch.sort(stable=True)")
    whole_tile = cuda_ms(lambda: rx.radix_sort(rec_t, (idx,), kb))
    sort32 = cuda_ms(lambda: torch.sort(rec_t, stable=True))

    n_chunks = -(-c // rx.CHUNK)
    table_bytes = 4 * n_chunks * (1 << bits)
    # histogram: each key read once, the count table written; scatter: key and
    # one payload row read and written, the offset table read; a shift, a
    # mask and a rank a key
    results["radix_hist"] = dict(
        max_abs_err=0.0, ms=statistics.mean(hist_ms), pass_ms=hist_ms,
        plain_ms=hist_plain, library_ms=bincount, **bound(4 * c + table_bytes, c))
    # what a pass stores, key and payload row, over its time: near the
    # memory rate only if runs of equal digits leave as whole sectors
    stored = 4 * c * (1 + v.shape[0])
    scat_gbs = [stored / (t * 1e-3) / 1e9 for t in scat_ms]
    results["cumsum"]["offset_table"] = dict(
        shape=[n_chunks, 1 << bits], ms=statistics.mean(offs_ms), pass_ms=offs_ms,
        plain_ms=offs_plain, **bound(2 * table_bytes, n_chunks << bits))
    results["radix_scatter"] = dict(
        max_abs_err=0.0, ms=statistics.mean(scat_ms), pass_ms=scat_ms,
        pass_stored_gb_per_s=scat_gbs, nine_rows_ms=nine_ms,
        nine_rows_stored_gb_per_s=40 * c / (nine_ms * 1e-3) / 1e9,
        plain_ms=scat_plain, library_ms=sort64,
        library_is="torch.sort(stable=True) of the int64 key: all passes at once",
        radix_sort_ms=whole, radix_sort_tile_key_ms=whole_tile,
        torch_sort_int32_tile_key_ms=sort32, **bound(16 * c + table_bytes, 3 * c))
    log(f"[2] radix_hist  C={c} keys, {bits}-bit digits, {n_chunks} chunks: every "
        f"pass exact (and 4 bits once); kernel ms a pass "
        + " ".join(f"{t:.4f}" for t in hist_ms)
        + f", plain {hist_plain:.4f} ms, torch.bincount {bincount:.4f} ms, bound "
        f"{results['radix_hist']['bound_ms']:.4f} ms")
    log(f"[2] radix_scatter one payload row: every pass exact (and nine rows, and "
        f"4 bits, once); kernel ms a pass " + " ".join(f"{t:.4f}" for t in scat_ms)
        + "; stored GB/s a pass " + " ".join(f"{g:.1f}" for g in scat_gbs)
        + f"; with nine rows {nine_ms:.4f} ms "
        f"({results['radix_scatter']['nine_rows_stored_gb_per_s']:.1f} GB/s stored), "
        f"plain {scat_plain:.4f} ms, bound "
        f"{results['radix_scatter']['bound_ms']:.4f} ms")
    log(f"[2] _prefix_offsets ({n_chunks}, {1 << bits}) -> ({n_chunks + 1}, "
        f"{1 << bits}), one launch of the prefix-sum kernel, every pass exact "
        f"(and 4 bits once); ms a pass " + " ".join(f"{t:.4f}" for t in offs_ms)
        + f", plain {offs_plain:.4f} ms, bound "
        f"{results['cumsum']['offset_table']['bound_ms']:.4f} ms")
    log(f"[2] radix_sort of the {c} packed keys with the source index, equal to "
        f"torch.sort(stable=True) element for element: {whole:.4f} ms ({passes} "
        f"passes) against torch.sort on the int64 key {sort64:.4f} ms; of the "
        f"tile ids alone ({kb} bits): {whole_tile:.4f} ms against torch.sort on "
        f"int32 {sort32:.4f} ms")


def check_probes(results):
    """Kernels 8 and 9 against their plain versions, and their probes: each
    probe is driven with the launch counts at 0 and read after. Returns the
    probes' launch counts."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.probes import bucketer_probe as bp
    from openglgaussiansplattingrenderer_tpu_torch.probes import cache_key_probe as cp

    dev = torch.device("cuda")
    rec = bp.make_records(64 * bp.R, dev, seed=1)
    rec[bp.TILE_ROW, :bp.R] = 7.0                # a bucket deeper than its 128 slots
    got, ref = bp.bucketer_level(rec, BUCKET_K), bp.bucketer_level_plain(rec, BUCKET_K)
    assert torch.equal(got, ref), "bucketer_level differs from the plain version"
    assert int((got != 0).sum()) > 0
    del rec, got, ref
    reset_launches()
    probe = bp.run(BUCKET_C, BUCKET_K)
    launches = read_launches()
    rec = bp.make_records(BUCKET_C, dev)
    ms = cuda_ms(lambda: bp.bucketer_level(rec, BUCKET_K))
    pms = cuda_ms(lambda: bp.bucketer_level_plain(rec, BUCKET_K), reps=3, warmup=1)
    n_chunks = BUCKET_C // bp.R
    # 64 B a record read; 16 x 128 x 4 B a bucket a chunk written
    results["bucketer_level"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=None, probe_ms=probe[
            "bucketer_level_lower_bound_ms"],
        **bound(4 * bp.ROWS * BUCKET_C + 4 * bp.ROWS * bp.CARRY * BUCKET_K * n_chunks,
                3 * BUCKET_C))
    log(f"[2] bucketer_level exact on 64 chunks; probe {json.dumps(probe)}; at "
        f"C={BUCKET_C}, K={BUCKET_K}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{results['bucketer_level']['bound_ms']:.4f} ms")
    del rec

    gen = torch.Generator(device=dev).manual_seed(9)
    for x in (torch.ones((8, 128), device=dev),
              torch.randn(1_000_003, generator=gen, device=dev)):
        assert torch.equal(cp.probe_affine(x), cp.probe_affine_plain(x)), (
            "probe_affine differs from x * 2 + 1")
    x = torch.ones((8, 128), device=dev)
    one = torch.ones((), device=dev)
    ms, pms = cuda_ms(lambda: cp.probe_affine(x)), cuda_ms(lambda: cp.probe_affine_plain(x))
    lms = cuda_ms(lambda: torch.add(one, x, alpha=2.0))
    big = torch.randn(LARGE_AFFINE, generator=gen, device=dev)
    large = dict(n=LARGE_AFFINE, ms=cuda_ms(lambda: cp.probe_affine(big)),
                 library_ms=cuda_ms(lambda: torch.add(one, big, alpha=2.0)),
                 **bound(8 * LARGE_AFFINE, 2 * LARGE_AFFINE))
    results["probe_affine"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lms,
                                   **bound(8 * x.numel(), 2 * x.numel()), large=large)
    reset_launches()
    cache = cp.run()
    launches["probe_affine"] = read_launches()["probe_affine"]
    log(f"[2] probe_affine exact at (8, 128) and 1,000,003 values; kernel {ms:.4f} "
        f"ms, plain {pms:.4f} ms, torch.add(alpha=2) {lms:.4f} ms; at "
        f"{LARGE_AFFINE} values kernel {large['ms']:.4f} ms, torch.add "
        f"{large['library_ms']:.4f} ms, bound {large['bound_ms']:.4f} ms; build-cache "
        f"probe {json.dumps(cache)}")
    return launches


def check_single_key_frames(frame, img_pair, img_packed):
    """The uniform flagship frame through the single-key record sorts. Each
    configuration renders once with the launch counts at 0, then is checked
    and timed. Returns {name: launch counts of that one frame}."""
    import dataclasses

    import torch

    from openglgaussiansplattingrenderer_tpu_torch.splats import inference_config

    packed = dataclasses.replace(frame.cfg, depth_key="packed")
    hoisted = dataclasses.replace(frame.cfg, hoist_depth_sort=True)
    cfgs = {"packed+radix": dataclasses.replace(packed, record_sort="radix"),
            "hoisted": hoisted,
            "hoisted+radix": dataclasses.replace(hoisted, record_sort="radix"),
            "packed+q16": inference_config(frame.cfg)}
    images, times, counts = {}, {}, {}
    for name, cfg in cfgs.items():
        f = frame.with_cfg(cfg)
        reset_launches()
        f.render()
        torch.cuda.synchronize()
        counts[name] = read_launches()
        radix = cfg.record_sort == "radix"
        for k in ("radix_hist", "radix_scatter"):
            assert (counts[name][k] > 0) == radix, (
                f"uniform {name}: {k} launched {counts[name][k]} times")
        log(f"[3] kernel launches of one uniform {name} frame: {counts[name]}")
        images[name], times[name] = check_frame(f"uniform {name}", f)
    assert torch.equal(images["packed+radix"], img_packed), (
        "the packed + radix frame differs from the packed torch.sort frame")
    assert torch.equal(images["hoisted+radix"], images["hoisted"]), (
        "the hoisted + radix frame differs from the hoisted torch.sort frame")
    err, bad = image_diff(images["hoisted"], img_pair)
    assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
        f"hoisted frame vs pair frame: max abs {err:.3e}, {bad} px > 1e-3")
    q_err, q_bad = image_diff(images["packed+q16"], img_packed)
    assert 0.0 < q_err < Q16_FLAG_TOL, f"q16 flagship frame: max abs {q_err:.3e}"
    log(f"[3] packed + radix and hoisted + radix frames bit-equal to their "
        f"torch.sort frames; hoisted vs pair max abs {err:.3e}; q16 vs f32 packed "
        f"max abs {q_err:.3e} ({q_bad} px > 1e-3, limit {Q16_FLAG_TOL}); "
        f"flagship_fps_inference {1e3 / times['packed+q16']:.2f}")
    return counts


def check_small_q16(device):
    """q16 against f32 on the 512-splat 64x64 scene of the JAX package's q16
    test: inside its 2e-3 budget, and not zero."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.splats import inference_config

    cfg = RenderConfig(chunk=32, dup_capacity_factor=8.0, depth_key="packed")
    f32 = Frame(ply_io.make_synthetic_scene(512, seed=7, extent=1.5),
                Camera(0.0, 0.0, -4.0, width=64, height=64), cfg, device)
    (img_f, st_f), (img_q, _) = f32.render(), f32.with_cfg(inference_config(cfg)).render()
    assert int(st_f["overflow"]) == 0
    err = float((img_q[..., :3] - img_f[..., :3]).abs().max())
    log(f"[3] 512-splat 64x64 frame, q16 vs f32: max abs {err:.3e} (limit "
        f"{Q16_SMALL_TOL})")
    assert 0.0 < err < Q16_SMALL_TOL, "small frame: q16 outside its budget"


def check_composite(name, frame):
    """Kernels 4 and 5 on the frame's own sorted records, with a seeded
    cotangent and each backward fed its own forward's output. Returns the
    two kernels' result rows."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc

    sf, bounds = frame.sorted_records()
    ox, oy, kw = frame.composite_inputs(sf)
    got = kc.composite(sf, bounds, ox, oy, **kw)
    pairs = {}
    ref = kc.composite_plain(sf, bounds, ox, oy, **kw, pair_counts=pairs)
    visited, blended = int(pairs["visited"]), int(pairs["blended"])
    err, bad = image_diff(frame.image(got), frame.image(ref))
    assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
        f"{name}: compositor vs plain: max abs {err:.3e}, {bad} px > 1e-3")
    ms = cuda_ms(lambda: kc.composite(sf, bounds, ox, oy, **kw))
    pms = cuda_ms(lambda: kc.composite_plain(sf, bounds, ox, oy, **kw))
    nrec, npix = int(bounds[-1]), got.shape[0] * got.shape[1]
    work = dict(records=nrec,
                max_records_per_tile=int((bounds[1:] - bounds[:-1]).max()),
                pairs_visited=visited, pairs_blended=blended)
    # read 36 B a binned record, write 16 B a pixel; operations from the
    # (pixel, record) pairs these records need
    fwd = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
               **bound(36 * nrec + 16 * npix,
                       FWD_FLOP_VISITED * visited + FWD_FLOP_BLENDED * blended),
               **work)
    w, h = frame.size
    log(f"[2] composite {name} ({w}x{h}, {nrec} records, at most "
        f"{work['max_records_per_tile']} a tile, {visited} pairs visited, "
        f"{blended} blended): max abs {err:.3e}, {bad} px > 1e-3; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
        f"({fwd['bound_by']})")

    gen = torch.Generator(device=sf.device).manual_seed(6)
    g = torch.randn(got.shape, generator=gen, device=sf.device)
    d_got = kc.composite_bwd(sf, bounds, ox, oy, got, g, **kw)
    d_ref = kc.composite_bwd_plain(sf, bounds, ox, oy, ref, g, **kw)
    assert bool(torch.isfinite(d_got).all()), f"{name}: composite_bwd not finite"
    assert not d_got[:, nrec:].any(), (
        f"{name}: composite_bwd: columns past bounds[-1] not zero")
    diff = (d_got - d_ref).abs()
    max_abs = float(diff.max())
    diff /= d_ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    worst = float(diff.max())
    loose = int((diff.amax(dim=0) > 1e-3).sum())
    del diff
    assert worst <= BWD_ROW_TOL, (
        f"{name}: composite_bwd vs plain: {worst:.3e} of the row's scale, "
        f"{loose} records beyond 1e-3")
    ms = cuda_ms(lambda: kc.composite_bwd(sf, bounds, ox, oy, got, g, **kw))
    pms = cuda_ms(lambda: kc.composite_bwd_plain(sf, bounds, ox, oy, ref, g, **kw))
    # read 36 B and write 36 B a binned record, read 32 B a pixel
    bwd = dict(max_abs_err=max_abs, max_row_rel_err=worst, ms=ms, plain_ms=pms,
               library_ms=None,
               **bound(72 * nrec + 32 * npix,
                       BWD_FLOP_VISITED * visited + BWD_FLOP_BLENDED * blended),
               **work)
    log(f"[2] composite_bwd {name}: worst row error {worst:.3e} of the row's "
        f"scale, {loose} records beyond 1e-3; kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']})")
    return fwd, bwd


def check_frame(name, frame, timed=True):
    """Render through render_arrays; check stats and image; time it."""
    import torch

    img, stats = frame.render()
    torch.cuda.synchronize()
    st = {k: v.item() for k, v in stats.items()}
    assert st["overflow"] == 0, f"{name}: overflow {st['overflow']}"
    w, h = frame.size
    assert img.shape == (h, w, 4), img.shape
    assert bool(torch.isfinite(img).all()), f"{name}: non-finite image"
    coverage = float((img[..., 3] > 0).float().mean())
    assert coverage > 0, f"{name}: empty image"
    ms = cuda_ms(frame.render) if timed else float("nan")
    log(f"[3] {name}: records {st['num_records']}, binned "
        f"{st['binned_records']}, max_bin {st['max_bin']}, coverage "
        f"{coverage:.4f}, frame {ms:.3f} ms (median of {REPS})")
    return img, ms


def mean_sq_loss(img):
    """The forward + backward benchmark loss of the JAX package's bench."""
    return (img[..., :3] ** 2).mean()


def check_fwdbwd(name, frame, loss=mean_sq_loss):
    """One forward + backward through render_arrays: zero overflow, every
    gradient finite; returns (median ms, gradients)."""
    import torch

    grads, stats = frame.grads(loss)
    torch.cuda.synchronize()
    assert int(stats["overflow"]) == 0, f"{name}: overflow {int(stats['overflow'])}"
    for k, g in grads.items():
        assert g.shape == frame.params[k].shape, (k, g.shape)
        assert bool(torch.isfinite(g).all()), f"{name}: non-finite gradient of {k}"
    assert float(grads["colors"].abs().max()) > 0, f"{name}: zero colour gradient"
    ms = cuda_ms(lambda: frame.grads(loss), reps=3, warmup=1)
    log(f"[6] {name}: forward + backward {ms:.3f} ms (median of 3), records "
        f"{int(stats['num_records'])}, max_bin {int(stats['max_bin'])}")
    return ms, grads


def stage_times(name, frame, loss=mean_sq_loss):
    """Median CUDA-event time of each stage of one forward + backward (after
    two warm-up passes), the backward taken stage by stage with
    torch.autograd.grad, and the per-tile record counts that bound the
    compositor."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    names = ("table", "cumsum", "expand", "sort", "composite", "image+loss",
             "image+loss bwd", "composite bwd", "sort bwd", "expand bwd (segsum)",
             "table bwd")
    n_fwd = 5                       # table .. composite: the frame's stages
    times = {k: [] for k in names}
    grad = torch.autograd.grad
    for it in range(REPS + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        p = {k: v.detach().requires_grad_(True) for k, v in frame.params.items()}
        ev[0].record()
        table, prep = fastpath.splat_table(p, *frame.args, frame.cfg)
        kw = fastpath.expand_kwargs(p["means"].shape[0], *frame.size, frame.cfg)
        ev[1].record()
        cum = ks.cumsum(prep["counts"])
        ev[2].record()
        rec = kr.expand(*table, cum, **kw)
        ev[3].record()
        sf, bounds = fastpath.sort_records(*rec, *frame.size, frame.cfg)
        ev[4].record()
        ox, oy, ckw = frame.composite_inputs(sf)
        tiled = kc.composite(sf, bounds, ox, oy, **ckw)
        ev[5].record()
        value = loss(frame.image(tiled))
        ev[6].record()
        (g_tiled,) = grad(value, tiled)
        ev[7].record()
        (g_sf,) = grad(tiled, sf, g_tiled)
        ev[8].record()
        (g_rec,) = grad(sf, rec[0], g_sf)
        ev[9].record()
        (g_fields,) = grad(rec[0], table[0], g_rec)
        ev[10].record()
        grad(table[0], list(p.values()), g_fields)
        ev[11].record()
        torch.cuda.synchronize()
        if it >= 2:
            for i, k in enumerate(names):
                times[k].append(ev[i].elapsed_time(ev[i + 1]))
    med = {k: statistics.median(v) for k, v in times.items()}
    per_tile = (bounds[1:] - bounds[:-1]).float()
    log(f"[4] {name} forward + backward stages (ms, median of {REPS}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
        + f"; the frame's stages {sum(list(med.values())[:n_fwd]):.4f}; sum "
        f"{sum(med.values()):.4f}; records per tile: max "
        f"{int(per_tile.max())}, mean {float(per_tile.mean()):.1f}, median "
        f"{float(per_tile.median()):.1f}")


def check_training(frame):
    """Five Adam steps through make_train_step on the frame's scene with
    perturbed colours, against its clean render. Returns the launch counts
    of the steps."""
    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.train import losses
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        params_from_raw,
        raw_from_params,
    )

    w, h = frame.size
    n = frame.params["means"].shape[0]
    tc = TrainConfig(lambda_dssim=0.2)
    with torch.no_grad():
        target = frame.render()[0][..., :3].contiguous()
    colors = frame.params["colors"].cpu().numpy()
    noisy = np.clip(colors + np.random.default_rng(0).normal(0, 40, colors.shape),
                    5, 250).astype(np.float32)
    start = frame.with_cfg(frame.cfg)
    start.params = dict(frame.params, colors=torch.as_tensor(noisy).to(target.device))

    def train_loss(img):
        return losses.gs_loss(img[..., :3], target, tc.lambda_dssim)

    fb_ms, _ = check_fwdbwd("uniform train loss", start, train_loss)
    step = make_train_step(frame.cfg, tc, w, h, with_grad_norms=True)
    with torch.no_grad():
        state = step.init(raw_from_params(start.params))

    reset_launches()
    loss_hist, psnr_hist, wall = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, target, *frame.args[:6])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        loss_hist.append(float(metrics["loss"]))
        psnr_hist.append(float(metrics["psnr"]))
    launches = read_launches()

    gnorm = metrics["densify_grad_norm"]
    assert gnorm.shape == (n,) and bool(torch.isfinite(gnorm).all()), gnorm.shape
    assert float(gnorm.max()) > 0, "densify_grad_norm is all zero"
    assert state.step == TRAIN_STEPS and state.opt_state["count"] == TRAIN_STEPS
    for k, v in state.raw.items():
        assert bool(torch.isfinite(v).all()), f"training: non-finite {k}"
    assert all(np.isfinite(loss_hist)) and loss_hist[-1] < loss_hist[0], loss_hist
    moved = float((state.raw["colors"] - start.params["colors"]).abs().max())
    assert moved > 0, "training: colours did not move"
    with torch.no_grad():
        end = frame.with_cfg(frame.cfg)
        end.params = params_from_raw(state.raw)
        overflow = int(end.render()[1]["overflow"])
    assert overflow == 0, f"training: overflow {overflow} after the steps"
    for k in ("cumsum", "expand", "segsum", "composite", "composite_bwd"):
        assert launches[k] > 0, f"{k} kernel never launched on the training path"
    log(f"[5] training, {n} splats at {w}x{h}, {TRAIN_STEPS} steps of "
        f"make_train_step (lambda_dssim {tc.lambda_dssim}, grad norms): loss "
        + " ".join(f"{v:.6f}" for v in loss_hist)
        + "; psnr " + " ".join(f"{v:.3f}" for v in psnr_hist)
        + f"; step wall ms {' '.join(f'{v:.1f}' for v in wall)} (median "
        f"{statistics.median(wall):.3f}); forward + backward {fb_ms:.3f} ms; "
        f"largest colour move {moved:.4f}; overflow {overflow}")
    log(f"[5] kernel launches on the training path: {launches}")
    return launches


def check_small_gradients(device):
    """A 150-splat 128x128 frame's gradients on the card against the port's
    CPU path (the plain versions)."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    def loss(img):
        return ((img[..., :3] - 0.2) ** 2).mean() + 0.1 * img[..., 3].mean()

    def grads_on(dev):
        scene = ply_io.make_synthetic_scene(150, seed=3, extent=2.0)
        frame = Frame(scene, Camera(0.0, 0.0, -6.0, width=128, height=128),
                      RenderConfig(chunk=64, dup_capacity_factor=24.0), dev)
        return frame.grads(loss)[0]

    g_card, g_host = grads_on(device), grads_on(torch.device("cpu"))
    worst = {}
    for k, g_cpu in g_host.items():
        scale = float(g_cpu.abs().max())
        worst[k] = float((g_card[k].cpu() - g_cpu).abs().max()) / max(scale, 1e-30)
    log("[6] 150-splat 128x128 gradients, card vs CPU path, max abs / max |g|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    assert max(worst.values()) <= GRAD_REL_TOL, "small frame: gradients disagree"


def main() -> int:
    import numpy as np  # noqa: F401  (the port needs it; fail early)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import dataclasses

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
    from openglgaussiansplattingrenderer_tpu_torch.render import autotune_capacity

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log("[1] card and power limit (nvidia-smi):")
    log(card)
    t0 = time.perf_counter()
    build.load_library()
    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}); kernels "
        f"built in {build.build_info['seconds']:.1f} s (load "
        f"{time.perf_counter() - t0:.1f} s): {build.build_info['path']}")
    for line in build.build_info["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            log(f"[1] ptxas {line.strip()}")

    # ---- scenes -----------------------------------------------------------
    fcfg0 = RenderConfig.for_resolution(FLAG_W, FLAG_H, tile_px=32, chunk=256)
    fcam = Camera(0.0, 0.0, -8.0, width=FLAG_W, height=FLAG_H)
    t0 = time.perf_counter()
    scenes = {
        "uniform": ply_io.make_synthetic_scene(
            FLAG_SPLATS, seed=99, extent=3.0, log_scale_range=(-5.8, -3.6)),
        "clustered": ply_io.make_clustered_scene(FLAG_SPLATS, seed=7, extent=3.0),
    }
    frames = {}
    for name, sc in scenes.items():
        f = Frame(sc, fcam, fcfg0, dev)
        f.cfg = autotune_capacity(f.params, *f.args[:6], FLAG_W, FLAG_H, fcfg0)
        frames[name] = f
    log(f"[1] flagship scenes made in {time.perf_counter() - t0:.1f} s; "
        f"grid {fcfg0.grid_x}x{fcfg0.grid_y}, capacity "
        f"{ {k: f.cfg.capacity_records for k, f in frames.items()} }")
    gcfg = RenderConfig.for_resolution(GATE_W, GATE_H, tile_px=32, chunk=256,
                                       dup_capacity_factor=8.0)
    gate = Frame(ply_io.make_synthetic_scene(GATE_SPLATS, seed=7, extent=2.5),
                 Camera(0.0, 0.0, -6.0, width=GATE_W, height=GATE_H), gcfg, dev)

    # ---- 2. kernels against their plain versions --------------------------
    results = {}
    with torch.no_grad():
        check_scan_and_expand(frames["uniform"], results)
        check_radix(frames["uniform"], results)
        # kernels 4 and 5 at the main path's shapes; the gate scene's
        # numbers ride along under "gate_scene"
        fwd, bwd = check_composite("uniform flagship", frames["uniform"])
        gate_fwd, gate_bwd = check_composite(
            f"gate scene ({GATE_SPLATS} splats)", gate)
        results["composite"] = dict(fwd, gate_scene=gate_fwd)
        results["composite_bwd"] = dict(bwd, gate_scene=gate_bwd)

        # ---- 3. the render path --------------------------------------------
        reset_launches()
        img_u, _ = check_frame("uniform pair", frames["uniform"])
        packed = dataclasses.replace(frames["uniform"].cfg, depth_key="packed")
        img_p, _ = check_frame("uniform packed", frames["uniform"].with_cfg(packed))
        check_frame("clustered pair", frames["clustered"])
        render_launches = read_launches()
        log(f"[3] kernel launches on the render path: {render_launches}")
        for k in ("cumsum", "expand", "composite"):
            assert render_launches[k] > 0, (
                f"{k} kernel never launched on the render path")
        for k in ("radix_hist", "radix_scatter"):
            assert render_launches[k] == 0, f"{k} launched on the torch.sort path"
        sort_launches = check_single_key_frames(frames["uniform"], img_u, img_p)
        del img_p
        check_small_q16(dev)

        plain = frames["uniform"].plain_render()
        err, bad = image_diff(img_u, plain)
        log(f"[3] uniform frame vs all-plain pipeline: max abs {err:.3e}, "
            f"{bad} px > 1e-3")
        assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
            "uniform frame diverges from the all-plain pipeline")
        del plain

        small = Frame(ply_io.make_synthetic_scene(150, seed=3, extent=2.0),
                      Camera(0.0, 0.0, -6.0, width=128, height=128),
                      RenderConfig(chunk=64, dup_capacity_factor=24.0), dev)
        img_c = small.render()[0]
        small_cpu = Frame(ply_io.make_synthetic_scene(150, seed=3, extent=2.0),
                          Camera(0.0, 0.0, -6.0, width=128, height=128),
                          small.cfg, torch.device("cpu"))
        img_h = small_cpu.render()[0]
        err_s = float((img_c.cpu() - img_h).abs().max())
        log(f"[3] 150-splat 128x128 frame, card vs CPU path: max abs {err_s:.3e}")
        assert err_s <= 1e-4, "small frame: card and CPU path disagree"

    # ---- 4. stage times of one forward + backward ------------------------
    for name in ("uniform", "clustered"):
        stage_times(f"{name} pair", frames[name])

    # ---- 5. the training path -------------------------------------------
    launches = check_training(frames["uniform"])

    # ---- 6. forward + backward of the other scenes ------------------------
    check_fwdbwd("uniform pair", frames["uniform"])
    check_fwdbwd("clustered pair", frames["clustered"])
    del frames, scenes
    mcfg0 = RenderConfig.for_resolution(MSPLATS_W, MSPLATS_H, tile_px=32,
                                        chunk=MSPLATS_CHUNK)
    msplats = Frame(
        ply_io.make_synthetic_scene(MSPLATS, seed=42, extent=3.0,
                                    log_scale_range=(-5.5, -3.2)),
        Camera(0.0, 0.0, -8.0, width=MSPLATS_W, height=MSPLATS_H), mcfg0, dev)
    msplats.cfg = autotune_capacity(msplats.params, *msplats.args[:6], MSPLATS_W,
                                    MSPLATS_H, mcfg0)
    check_fwdbwd(f"{MSPLATS} splats {MSPLATS_W}x{MSPLATS_H}", msplats)
    check_small_gradients(dev)

    # ---- 2, continued: the probe kernels (3.2 GB written a launch, and a
    # rebuild of the library: kept behind every time of the main paths) -----
    with torch.no_grad():
        probe_launches = check_probes(results)

    # ---- 7. results ---------------------------------------------------------
    # "launches" counts the training path's five steps for the first five
    # kernels, one packed + radix frame for the two radix-sort kernels and
    # one run of its probe for each probe kernel; the default render path's
    # three frames (and their timing repetitions) and one packed + radix
    # frame are counted beside it
    launches.update({k: sort_launches["packed+radix"][k]
                     for k in ("radix_hist", "radix_scatter")})
    launches.update({k: probe_launches[k] for k in ("bucketer_level", "probe_affine")})
    rows = []
    for name, (src, replaces) in KERNELS.items():
        assert launches[name] > 0, f"{name} kernel never launched on its path"
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "render_path_launches": render_launches[name],
                     "radix_frame_launches": sort_launches["packed+radix"][name],
                     **results[name]})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
