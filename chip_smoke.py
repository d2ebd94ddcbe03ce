#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, on one card
    python3 chip_smoke.py --cards 4    # phase [9] only, over four cards
    (``--pg-worker DIR`` is one rank of phase [9]'s process group, started
    by ``parallel.multihost.spawn``)

Builds the port's CUDA kernels from ``openglgaussiansplattingrenderer_tpu_torch/
csrc`` (nvcc, at first use), then:

1. prints the card, its power limit, the PyTorch version and the build time;
2. holds each of the eleven kernels and the record sort stage against
   their plain PyTorch versions on the card and times both (CUDA events, median), beside the least time the
   card could take for the same work (``bound_ms``) and, where one PyTorch
   call computes the same function, that call's time (``library_ms``):
   the splat table (kernels 10 and 11, ``csrc/table.cu``) on the uniform
   and clustered flagship parameters, an SH-3 variant of the uniform one
   and the gate scene: counts, tile_min, tile_ext, valid and culled
   exactly equal, every float output bit-equal or within
   ``TABLE_FLOAT_TOL`` (1e-6) of its row's largest magnitude with the
   count of elements that are not bit-equal printed, the backward within
   ``BWD_ROW_TOL`` (1e-4) of each gradient tensor's largest magnitude
   against autograd of the plain forward on a seeded cotangent and on the
   frame's own segment-sum output, each also on the device alone; prefix sum on the flagship frame, bit-equal; the prefix
   sum again at 67,108,864 values, where the device and not the host's
   dispatch sets the time, and on one value, as the host's cost of a launch;
   the expansion (bit-equal) and its transpose, the segment sum (within
   ``SEGSUM_ROW_TOL`` of the row's scale, equal run to run, zero on empty
   splats), on the uniform and clustered flagship tables and, in phase 6,
   the 1080p scene's, each also timed on the device alone (torch.profiler);
   the onesweep radix sort on the frame's own 6.29M packed keys: the
   counts of every pass (one launch) and each pass's scatter exact, both
   also on the device alone, the scatter's stored bytes over its device
   time a pass, and the whole sort and the sort of the tile ids against
   ``torch.sort(stable=True)`` element for element, each between events and
   on the device alone; the record sort stage (``kernels/record_sort.py``:
   the counts launch with the bounds, a radix scatter a pass, the row gather;
   the un-sort) on the uniform and clustered flagship records, pair and
   packed keys, and in phase 6 the 1080p records (pair: the packed key holds
   512 tiles), its sorted fields, bounds and inverse index bit-equal to the
   plain stage (torch.sort of the int64 key, index_select, searchsorted) and
   its un-sort to index_copy_ in both cotangent modes, each timed between
   events, on the device alone and launch by launch, beside the plain stage
   call by call and the library calls it replaced; the bucketing-level probe kernel exact on 64
   chunks and timed through its probe, between events and on the device
   alone at 6,291,456 records, and the
   build-cache probe with its kernel, timed at (8, 128) and at 1,000,003
   values, there also 40 calls back to back and on the device alone
   (torch.profiler) beside ``torch.add`` (these two run last, behind every
   time of the main paths);
   compositor
   forward (image max abs diff <= 5e-3 with <= 10 px above 1e-3) and
   backward (per row within a stated share of the row's largest gradient,
   columns past the last tile zero) on the uniform flagship frame's sorted
   records, on the 10k-splat gate scene and on the clustered flagship
   frame's sorted records (one tile of some 660,000 records; the plain
   versions timed once there), with a seeded cotangent and each backward
   fed its own forward's output;
3. drives the render path through ``render_arrays`` at the reference's
   operating point (3,616,103 splats at 1024x512, uniform and clustered
   scenes), with every kernel launch counter reset just before and read
   just after; checks zero overflow, a finite image with coverage, every
   forward kernel launched (the splat table once a frame, the record sort
   stage's 2 + 6 launches), the uniform frame against the all-plain
   pipeline, and a small frame against the port's CPU path; the default
   frame and its gradients bit-equal on the record sort kernels and on the
   plain stage, and no torch.sort, index_select, searchsorted or index_copy_
   kernel on the device in a forward + backward on the kernels; then the
   uniform frame through the single-key record sorts (packed + radix and
   hoisted + radix bit-equal to their ``torch.sort`` frames, hoisted, and
   the q16 inference mode within 0.01 of the f32 frame), each with its own
   launch counts, and q16 against f32 on a 512-splat scene within 2e-3;
3a. holds the kernels against the oracle pipeline (``use_pallas=False``,
   plain PyTorch that shares no kernel with them) on the same card: on the
   10k-splat gate scene the frame (``bench.py:191-194``'s limits, a warning
   past the attributed point of ``bench.py:185-190``), the gradients of
   ``mean(img[..., :3]**2)`` (kernels 3 and 5 against autograd, within
   ``GRAD_REL_TOL``) and the depth maps of ``render_depth``; on the uniform
   flagship the forward frame under ``torch.no_grad()``, the oracle's
   ``max_per_tile`` its own largest bin rounded up to ``chunk``; each
   differing pixel replayed in float64 by ``scripts/torch_gate_divergence.py``
   to name the threshold flip behind it; the counts reset before the
   kernels' frames and read after, and the oracle launching none;
4. prints each flagship scene's per-stage device times of one forward +
   backward (CUDA events: "sort" and "sort bwd" are the record sort stage),
   and in phase 6 the 1080p scene's;
5. drives the training path: five Adam steps of ``make_train_step`` (L1 +
   D-SSIM, per-splat densification statistic) on the uniform flagship scene
   with perturbed colours against its clean render, counters reset just
   before and read just after; checks finite gradients, zero overflow, a
   falling loss and the training path's seven kernels launched (the splat
   table, its backward and the un-sort once a step) and the record sort
   stage; the five losses bit-equal on the plain record sort stage; times
   forward + backward and the whole step;
5b. trains with adaptive density control: the same scene and target padded
   to 4,194,304 rows (the padded start's frame bit-equal to the unpadded
   one under ``tight_rect`` True and False, the live record count
   unchanged, every dead row on screen culled by kernel 2 without the
   tight rect: four records each at this camera), the train step timed
   at that capacity and
   ``densify_and_prune`` there (events and the device alone), then twelve
   steps of ``fit_scene_adaptive`` (densify at steps 4 and 8 with a
   threshold that picks 1% of the live splats, split threshold 0.005 x the
   extent, opacity reset at step 10), counters reset just before and read
   just after: clones and splits, every dead row parked, the alive count
   balanced, zero overflow, a finite loss falling at every step no densify
   precedes before the reset, kernels 1-5, 10 and 11 launched; then the training CLI
   (``scripts/torch_train_cli.py``) in-process on the card: the PLY route
   on the uniform flagship (three 1024x512 orbit views, twenty steps,
   ``--densify``) and the COLMAP route on a small workspace, each with its
   own counts, exit 0, its three files and a finite PSNR;
6. times one forward + backward of the clustered flagship and of the
   1,000,000-splat 1920x1080 scene (the record sort stage and the un-sort
   launched there), and holds a small frame's gradients on the card
   against the port's CPU path;
8. drives the render CLI (``scripts/torch_render_cli.py``) in-process on
   the uniform flagship's PLY at the reference pose, route by route
   (default, q16, depth, a 4-frame orbit; golden on the gate scene), each
   PNG byte-equal to the frame rendered here and written by the same
   encoder, q16 within ``Q16_FLAG_TOL`` of the packed f32 frame; then the
   interactive viewer's server on port 0: ``/frame``, ten keys through
   ``/key`` (the served camera equal to ``apply_key`` on the host), 30
   ``/stream`` frames, ``/frame`` at the moved pose equal to
   ``render_camera_u8``, ``/stats``; then ``scripts/
   torch_viewer_fps_bench.py`` at its default and at the flagship; and the
   numpy golden's gate frame held to the oracle at
   ``depth_key="reference"`` within ``GOLDEN_TOL``;
9. the multi-device layer on four logical shards of the one card: the
   fast sharded frame (both flagships padded to 3,616,104 rows) within
   1e-5 of the single-device frame at ``exch_factor`` 4 with no overflow,
   the default factor's overflow and warning, the q16 route and its
   raising backward, gs-loss gradients within ``GRAD_REL_TOL`` and one
   ``train_step_fast_sharded``, the oracle ``render_sharded`` on the gate
   scene launching no kernel, a data-parallel step of four orbit views
   against the mean of four single-view gradients and an 8-step
   ``fit_scene_dp`` with one densify; a 2 x 2 (view x splat) step of two
   of those views against two single-view steps (loss, gradients and
   densify statistic within ``GRAD_REL_TOL``, no overflow), an 8-step
   ``fit_scene_2d`` with one densify against the same fit on 1 x 1; the
   process-group backend (``parallel/multihost.py``): the flagship frame
   and one step on two gloo ranks of the card (four NCCL ranks under
   ``--cards 4``), the frame bit-equal to the single-controller frame and
   the gradients within ``GRAD_REL_TOL``; the training CLI's
   ``--mesh2d`` and ``--data-parallel`` routes; ``dryrun_multichip(8)``;
   the scaling report (``scripts/torch_scaling_report.py``); times and
   peak memory;
10. the scripts of ``scripts/torch_*.py`` that port the JAX package's
   benches, each through its ``main`` on the card at its full width, the
   counts reset just before and read just after each: the flagship bench
   (3,616,103 splats at 1024x512, both scenes, no overflow, the headline
   line), the scale test (3,616,103 splats at 1920x1080 through the PLY
   writer and the native loader, the loaded means within 1e-6 of the
   written, no overflow, finite gradients), the baseline configs (the
   single Gaussian within 1e-2 of the golden, the worst directional finite
   difference within 15%), the radix-sort bench at its sizes and at
   6,291,456 keys (every sort exact), the stage profile (1M splats at
   1080p with the backward prefixes; the "sort2" bounds end at the full
   frame's binned records, and kernels 4 and 5 on those sorted records
   held to their plain versions as in phase [2]), the training bench (CAP
   100,000, 600 steps: PSNR rises, at most CAP alive, one compositor
   backward a step), the novel-view bench (CAP 1,000,000, GT 500,000, 72
   poses, cut to 1,000 steps in two segments so that its resume runs: a
   finite holdout PSNR) and the holdout eval of its checkpoint (within
   0.01 dB of the bench's); kernels 1-7, 10 and 11 launched in the phase;
7. prints a JSON line of phase [3a]'s numbers, one of phases [8] and [9],
   one of phase [10]'s scripts, a JSON line of per-kernel results and,
   last, the device line.

Every check raises on failure; the exit code is nonzero and no result line
is printed. There is no fallback: without CUDA the script exits 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# Kernels against the oracle. The gate scene: bench.py:191-194's limits are
# GATE_MAX_ABS and GATE_MAX_PX; past the point its divergence was attributed
# to threshold flips (bench.py:185-190) a warning names the replay script.
# The flagship frame: the reference's own CPU-vs-GPU tolerance
# (Splats.cpp:783-843), and at most 0.01% of its pixels above 1e-3.
ATTRIBUTED_DIFF, ATTRIBUTED_PX = 4.5e-3, 6
ORACLE_FLAG_TOL, ORACLE_FLAG_PX_SHARE = 1e-2, 1e-4
DEPTH_TOL, DEPTH_ALPHA_TOL = 1e-4, 1e-5   # the CPU suite's render_depth limits
GOLDEN_TOL = 4e-3                  # the north star's golden contract (ROADMAP.md)
BUCKET_C, BUCKET_K = 6 * 1024 * 1024, 32   # the bucketing probe's own size
# a size at which the device and not the host's dispatch sets a small
# kernel's time: 256 MB in, 256 MB out for the prefix sum
LARGE_SCAN = 64 * 1024 * 1024
LARGE_AFFINE = 1_000_003
# Phase [5b]: adaptive density control on the uniform flagship, padded to a
# static capacity of 2^22 rows (578,201 free). percent_dense puts the split
# threshold (percent_dense x extent ~ 0.015) inside the scene's scales
# (0.003-0.027), so both the clone and the split branch run; the gradient
# threshold is set to pick DENSIFY_SHARE of the live splats.
DENSIFY_CAPACITY = 4_194_304
DENSIFY_STEPS, DENSIFY_START, DENSIFY_INTERVAL, DENSIFY_RESET = 12, 4, 4, 10
DENSIFY_PERCENT, DENSIFY_SHARE = 0.005, 0.01
CLI_STEPS, CLI_VIEWS = 20, 3
# Phase [8]: the viewer's key sequence (the reference's 0.1-unit and
# 1-degree steps), the frames pulled from /stream, the CLI's orbit frames.
VIEWER_KEYS = ("w", "w", "a", "right", "right", "up", "space", "d", "left", "shift")
STREAM_FRAMES, ORBIT_FRAMES, BENCH_FRAMES = 30, 4, 60
CLI_ROUTES = ("default", "q16", "depth", "orbit", "golden")
# Phase [9]: logical shards on the one card; the data-parallel batch, the
# fit's steps and its one densify (at the threshold near phase [5b]'s 1%
# pick).
MESH_SHARDS = 4
DP_BATCH, DP_STEPS, DP_DENSIFY_AT, DP_DENSIFY_THRESHOLD = 4, 8, 4, 5e-5
# the 2-D (view x splat) mesh of phase [9]: two views by two splat shards
M2_DV, M2_DS = 2, 2
M2_FIT_HEADROOM = 1.25             # record capacity of the 2-D fits over the frame's
# the process-group ranks of phase [9] on one card (gloo), the launcher's
# limit on the ranks' lives and each rank's limit on a collective's wait;
# the dry run's logical shards
PG_RANKS_ONE_CARD, PG_TIMEOUT_S, PG_INIT_TIMEOUT_S = 2, 600.0, 300.0
DRYRUN_SHARDS = 8
# phase [10], the scripts: the novel-view bench at its width (CAP 1,000,000,
# GT 500,000, 72 poses) cut to two 500-step segments, so that its resume
# runs; the radix-sort bench at its sizes and the frame's record count
NV_STEPS, NV_SEGMENT = 1000, 500
RADIX_SIZES = "524288,1048576,2097152,6291456"
SCRIPT_ARGV = {                    # each script's own defaults, but for these
    "torch_flagship_bench": [],
    "torch_scale_test": [],
    "torch_baseline_eval": [],
    "torch_radix_sort_bench": ["--sizes", RADIX_SIZES],
    "torch_profile_stages": ["--bwd-stages"],
    "torch_train_bench": [],
    "torch_novel_view_bench": ["--steps", str(NV_STEPS), "--segment", str(NV_SEGMENT)],
    "torch_nv_holdout_eval": [],
}
BASELINE_GOLDEN_TOL = 1e-2         # the reference's own CPU/GPU tolerance
FD_REL_TOL = 0.15                  # finite differences, ARCHITECTURE.md:179
NV_EVAL_TOL_DB = 0.01              # the holdout eval against the bench, same checkpoint

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
# The splat table (kernels 10, 11) against its plain version: float outputs
# bit-equal or within this share of their row's largest magnitude (the SH
# colours go through torch reductions and libm calls whose rounding the
# kernel copies but cannot be proven to share); integers and masks exactly
# equal.
TABLE_FLOAT_TOL = 1e-6
# the SH-3 variant of the uniform flagship: sh_rest ~ N(0, 0.2^2) from a seed
# (the scene's own coefficients are zero; captured scenes' f_rest lie
# within a few tenths)
TABLE_SH_SEED, TABLE_SH_SCALE = 13, 0.2
# Float operations a splat of the table kernels, counted from
# csrc/table.cu with sqrt, division and log as one: the forward on the cov6
# route (projection, EWA covariance, conic, radius, tight rect, tile rect),
# + the covariance from scales and quats, + SH colours at degree 3; the
# backward (the forward's recomputation and the chain rule) likewise.
TABLE_FWD_FLOP, TABLE_COV_FLOP, TABLE_SH_FLOP = 235, 78, 256
TABLE_BWD_FLOP, TABLE_COV_BWD_FLOP, TABLE_BWD_SH_FLOP = 430, 211, 480

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
    "radix_counts": (f"{PKG}/csrc/radix_sort.cu",
                     f"{TPU_PKG}/ops/pallas/radix_sort.py:76"),
    "radix_scatter": (f"{PKG}/csrc/radix_sort.cu",
                      f"{TPU_PKG}/ops/pallas/radix_sort.py:133"),
    "bucketer_level": (f"{PKG}/csrc/bucketer_probe.cu", "scripts/bucketer_probe.py:68"),
    "probe_affine": (f"{PKG}/csrc/probe_affine.cu", "scripts/cache_key_probe.py:34"),
    # the port's own: no pallas_call; XLA fuses the jitted preprocess there
    "splat_table": (f"{PKG}/csrc/table.cu", f"{TPU_PKG}/ops/projection.py:42"),
    "splat_table_bwd": (f"{PKG}/csrc/table.cu", f"{TPU_PKG}/ops/projection.py:42"),
    # the port's own stage: the JAX package's payload lax.sort (XLA there),
    # its searchsorted, and the sort's backward
    "record_sort": (f"{PKG}/csrc/radix_sort.cu",
                    f"{TPU_PKG}/ops/pallas/records.py:255"),
    "record_unsort": (f"{PKG}/csrc/record_gather.cu",
                      f"{TPU_PKG}/ops/pallas/records.py:189"),
}
# the sources of the record sort stage's launches: the counts and the
# passes (kernels 6 and 7's file), the row gather of the fields
RECORD_SORT_SOURCES = (f"{PKG}/csrc/radix_sort.cu", f"{PKG}/csrc/record_gather.cu")
# device kernel names of the calls the record sort stage replaced
# (torch.sort, index_select, searchsorted, index_copy_), lower case: none
# may run on the kernel stage of a default frame
LIBRARY_SORT_NAMES = ("sort", "index_select", "indexselect", "searchsorted",
                      "index_copy", "indexcopy")
# the kernels every frame launches, and those a forward + backward adds
FRAME_KERNELS = ("splat_table", "cumsum", "expand", "composite")
STEP_KERNELS = FRAME_KERNELS + ("segsum", "composite_bwd", "splat_table_bwd")


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


def cuda_ms_once(fn):
    """(result, device time in ms) of one call of ``fn``, not warmed up: for
    a plain version that takes seconds."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def device_us(fn, calls: int = 50, tries: int = 3):
    """Mean time on the device of what one call of ``fn`` launches there, in
    microseconds, from torch.profiler's kernel and memset records: the
    host's dispatch is not in it. The profiler at times loses records, and
    a lost record would read as a faster call. So each profiled run starts
    and ends with a spin kernel, whose records are dropped whether they
    came or not, and counts only if it holds ``calls`` times the records of
    one call, name for name; a run that does not is logged and run again,
    up to ``tries`` runs. None where no run is whole or nothing runs on the
    device."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def records(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(n):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        return [e for e in prof.events()
                if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]

    fn()
    torch.cuda.synchronize()
    one = Counter(e.name for e in records(1))
    if not one:
        return None
    want = Counter({name: k * calls for name, k in one.items()})
    def short(c):
        return {name[:60]: k for name, k in c.items()}

    for _ in range(tries):
        got = records(calls)
        held = Counter(e.name for e in got)
        if held == want:
            return sum(e.time_range.elapsed_us() for e in got) / calls
        log(f"device_us: the profiler held {sum(held.values())} device records of "
            f"{calls} calls, not {sum(want.values())} (lost: "
            f"{short(want - held)}; more: {short(held - want)}); run again")
    return None


def device_launches(fn, runs: int = 5):
    """Each launch of one call of ``fn`` on the device, in launch order:
    [(name, median us)] over ``runs`` profiled calls, each bracketed by spin
    kernels as in ``device_us``; a run that holds another number of records
    than the first is left out. None where no run held a record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        got = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)
        seen.append([(e.name, e.time_range.elapsed_us()) for e in got])
    seen = [r for r in seen if r and len(r) == len(seen[0])]
    if not seen:
        return None
    return [(seen[0][j][0][:48], statistics.median(r[j][1] for r in seen))
            for j in range(len(seen[0]))]


@contextlib.contextmanager
def plain_record_sort():
    """The record sort stage on its plain version (torch.sort, index_select,
    searchsorted; index_copy_ back) on CUDA tensors too, inside the block:
    the route the kernels are held to, frame for frame and step for step."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs

    fwd, unsort = rs.record_sort_fwd, rs.record_unsort
    rs.record_sort_fwd = (lambda fields, words, num_tiles, key, passes_model=False,
                          inverse=True: rs.record_sort_plain(fields, words, num_tiles, key))
    rs.record_unsort = (lambda g, order, paired_rows=None:
                        rs.unsort_plain(g, order, rs._paired(paired_rows)))
    try:
        yield
    finally:
        rs.record_sort_fwd, rs.record_unsort = fwd, unsort


def device_names(fn):
    """{full kernel name: records} of one profiled call of ``fn`` on the
    device (after a warm-up call)."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)


def device_top(fn, top: int = 8):
    """What one call of ``fn`` runs on the device, from torch.profiler's
    kernel and memset records of one profiled call (after a warm-up call):
    (device ms in all, records, [(name, ms, count)] of the ``top`` names by
    time). The profiler at times loses a record (``device_us``), so the sum
    is a floor. None where it held no device record."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name[:70]] += e.time_range.elapsed_us() / 1e3
            count[e.name[:70]] += 1
    if not ms:
        return None
    ranked = sorted(ms, key=ms.get, reverse=True)[:top]
    return sum(ms.values()), sum(count.values()), [(k, ms[k], count[k]) for k in ranked]


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
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
    from openglgaussiansplattingrenderer_tpu_torch.probes import bucketer_probe, cache_key_probe

    return {"cumsum": ks.cumsum, "expand": kr.expand, "segsum": kr.segsum,
            "composite": kc.composite, "composite_bwd": kc.composite_bwd,
            "radix_counts": rx.radix_counts, "radix_scatter": rx.radix_scatter,
            "bucketer_level": bucketer_probe.bucketer_level,
            "probe_affine": cache_key_probe.probe_affine,
            "splat_table": kt.splat_table, "splat_table_bwd": kt.splat_table_bwd,
            "record_sort": rs.record_sort, "record_unsort": rs.record_unsort}


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


def check_scan(frame, results):
    """Kernel 1 at the flagship frame's shape, at a large size and on one
    value."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    _, counts, _ = frame.table()
    n = counts.numel()
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


def check_expand_segsum(name, frame):
    """Kernels 2 and 3 on the frame's own splat table: the expansion
    bit-equal to its plain version, the segment sum within SEGSUM_ROW_TOL of
    the row's scale, equal from run to run and zero on empty splats; each
    timed by CUDA events around one call and on the device alone
    (torch.profiler). Returns the two kernels' result rows."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    def us(v):
        return "not measured" if v is None else f"{v:.2f}"

    table, counts, kw = frame.table()
    n, cap = counts.numel(), kw["capacity"]
    cum = ks.cumsum(counts)
    got = kr.expand(*table, cum, **kw)
    ref = kr.expand_plain(*table, cum, **kw)
    for what, a, b in zip(("fields", "tile", "depth"), got, ref):
        assert torch.equal(a, b), f"{name}: expand {what} differ from the plain version"
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
    del got, ref
    ms = cuda_ms(lambda: kr.expand(*table, cum, **kw))
    dev_us = device_us(lambda: kr.expand(*table, cum, **kw), calls=20)
    pms = cuda_ms(lambda: kr.expand_plain(*table, cum, **kw))
    total = min(int(cum[-1]), cap)
    empty = int((counts == 0).sum())
    shape = dict(splats=n, capacity=cap, records=total, empty_splats=empty)
    # written: 9 fields + tile + depth a record (44 B); read: 9 fields, the
    # tile rect (4 ints), depth and the prefix sum a splat (60 B). The cull
    # costs about 60 float operations a record below total.
    expand = dict(max_abs_err=err, ms=ms, device_us=dev_us, plain_ms=pms,
                  library_ms=None, **bound(44 * cap + 60 * n, 60 * total), **shape)
    log(f"[2] expand {name}: C={cap} records (total {total}), {n} splats ({empty} "
        f"empty) bit-equal; kernel {ms:.4f} ms, on the device alone {us(dev_us)} us, "
        f"plain {pms:.4f} ms, bound {expand['bound_ms']:.4f} ms")

    gen = torch.Generator(device=cum.device).manual_seed(5)
    g = torch.randn((kr.NUM_FIELDS, cap), generator=gen, device=cum.device)
    got = kr.segsum(g, cum)
    ref = kr.segsum_plain(g, cum)
    scale = ref.abs().amax(dim=1).clamp_min(1e-30)
    rel = float(((got - ref).abs().amax(dim=1) / scale).max())
    assert rel <= SEGSUM_ROW_TOL, f"{name}: segsum vs plain: {rel:.3e} of the row's scale"
    assert torch.equal(got, kr.segsum(g, cum)), f"{name}: segsum differs run to run"
    zero = torch.nonzero(counts == 0).squeeze(1)
    assert zero.numel() and not got[:, zero].any(), f"{name}: empty splats not zero"
    ms = cuda_ms(lambda: kr.segsum(g, cum))
    dev_us = device_us(lambda: kr.segsum(g, cum), calls=20)
    pms = cuda_ms(lambda: kr.segsum_plain(g, cum))
    ids = torch.searchsorted(cum, torch.arange(total, dtype=torch.int32,
                                               device=cum.device), right=True)
    lib_out = torch.zeros((kr.NUM_FIELDS, n), device=cum.device)
    lms = cuda_ms(lambda: lib_out.zero_().index_add_(1, ids, g[:, :total]))
    # read: 36 B a record below total and the prefix sum; written: 36 B a
    # splat; one add a value read
    segsum = dict(max_abs_err=float((got - ref).abs().max()), max_row_rel_err=rel,
                  ms=ms, device_us=dev_us, plain_ms=pms, library_ms=lms,
                  **bound(36 * total + 40 * n, 9 * total), **shape)
    log(f"[2] segsum {name}: C={cap} -> n={n}: {rel:.3e} of the row's scale, equal "
        f"run to run; kernels {ms:.4f} ms, on the device alone {us(dev_us)} us, "
        f"plain {pms:.4f} ms, index_add_ {lms:.4f} ms, bound "
        f"{segsum['bound_ms']:.4f} ms")
    return expand, segsum


def table_bound(inputs, out, sh_row: int, backward: bool = False) -> dict:
    """``bound`` of the splat table kernels from their arguments: each input
    read once and each output written once (the backward reads the inputs
    but the colours, and the nine cotangents, and writes one gradient an
    input), and the float operations counted from ``csrc/table.cu``."""
    n = inputs["means"].shape[0]
    read = sum(t.numel() * t.element_size() for k, t in inputs.items()
               if t is not None and not (backward and k in ("colors", "shift2d")))
    quats = inputs["cov6"] is None
    if backward:
        # + the cotangents read; the gradients written: the inputs' bytes and
        # the colours'
        return bound(2 * read + 36 * n + 12 * n,
                     n * (TABLE_BWD_FLOP + TABLE_COV_BWD_FLOP * quats
                          + TABLE_BWD_SH_FLOP * bool(sh_row)))
    written = sum(t.numel() * t.element_size() for t in out if t is not None)
    return bound(read + written, n * (TABLE_FWD_FLOP + TABLE_COV_FLOP * quats
                                      + TABLE_SH_FLOP * bool(sh_row)))


def check_splat_table(name, frame):
    """Kernels 10 and 11 on the frame's own parameters against their plain
    versions: counts, tile_min, tile_ext, valid and culled equal; every
    float output bit-equal or within ``TABLE_FLOAT_TOL`` of its row's
    largest magnitude, with the count of elements that are not bit-equal;
    the backward within ``BWD_ROW_TOL`` of each gradient tensor's largest
    magnitude against autograd of the plain forward (and beside its plain
    analytic version), on a seeded cotangent and on the frame's own
    segment-sum output. Each timed between CUDA events and on the device
    alone. Returns the two kernels' result rows."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt

    def us(v):
        return "not measured" if v is None else f"{v:.2f}"

    view, vp = frame.args[0], frame.args[1]
    spec = (*frame.args[2:], frame.cfg)
    inputs = kt.table_inputs(frame.params, frame.cfg)
    sh_row = 0 if inputs["sh_rest"] is None else inputs["sh_rest"].shape[1]
    n = inputs["means"].shape[0]
    names = ("fields", "mean2d", "tile_min", "tile_ext", "counts", "depth",
             "raw_depth", "radius", "valid", "culled")
    got = kt.splat_table_fwd(inputs, view, vp, spec)
    ref = kt.splat_table_fwd_plain(inputs, view, vp, spec)
    bits = {}
    worst = max_abs = 0.0
    for what, a, b in zip(names, got, ref):
        if a is None:
            continue
        if a.dtype in (torch.int32, torch.bool):
            bad = torch.nonzero((a != b).reshape(n, -1).any(dim=1)).squeeze(1)
            if bad.numel():
                k = bad[:8]
                log(f"[2] splat_table {name}: {what} differs at {bad.numel()} splats, "
                    f"first {k.tolist()}: kernel {a[k].tolist()}, plain {b[k].tolist()}; "
                    f"fields there kernel {got[0][:, k].t().tolist()}, plain "
                    f"{ref[0][:, k].t().tolist()}")
            assert not bad.numel(), f"{name}: splat_table {what} differs from the plain version"
            continue
        rows = a.reshape(a.shape[0], -1) if what == "fields" else a.reshape(1, -1)
        want = b.reshape(rows.shape)
        same = (rows == want) | (torch.isnan(rows) & torch.isnan(want))
        bits[what] = int((~same).sum())
        finite = torch.isfinite(want)
        assert torch.equal(torch.isfinite(rows), finite), f"{name}: {what} finiteness differs"
        scale = torch.where(finite, want.abs(), 0).amax(dim=1, keepdim=True).clamp_min(1e-30)
        diff = torch.where(finite, (rows - want).abs(), 0)
        max_abs = max(max_abs, float(diff.max()))
        worst = max(worst, float((diff / scale).max()))
    assert worst <= TABLE_FLOAT_TOL, (
        f"{name}: splat_table floats vs plain: {worst:.3e} of the row's scale")
    ms = cuda_ms(lambda: kt.splat_table_fwd(inputs, view, vp, spec))
    dev_us = device_us(lambda: kt.splat_table_fwd(inputs, view, vp, spec), calls=20)
    pms = cuda_ms(lambda: kt.splat_table_fwd_plain(inputs, view, vp, spec))
    fwd = dict(max_abs_err=max_abs, max_row_rel_err=worst, not_bit_equal=bits,
        ms=ms, device_us=dev_us, plain_ms=pms, library_ms=None, splats=n,
        sh_row=sh_row, **table_bound(inputs, got, sh_row))
    log(f"[2] splat_table {name}: {n} splats, sh_row {sh_row}: integers equal; floats "
        f"{worst:.3e} of the row's scale, not bit-equal {bits}; kernel {ms:.4f} ms, "
        f"on the device alone {us(dev_us)} us, plain {pms:.4f} ms, bound "
        f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
    del got, ref

    # the backward: a seeded cotangent, then the frame's own segsum output
    diff_keys = [k for k in kt.INPUTS[:7] if inputs[k] is not None]
    gen = torch.Generator(device=view.device).manual_seed(12)
    cots = {"seeded": torch.randn((kr.NUM_FIELDS, n), generator=gen, device=view.device)}
    table, prep = kt.splat_table(frame.params, *frame.args, frame.cfg)
    f = table[0].detach().requires_grad_(True)
    kw = fastpath.expand_kwargs(n, *frame.size, frame.cfg)
    with torch.enable_grad():
        rec = kr.expand(f, *table[1:], ks.cumsum(prep["counts"]), **kw)
        sf, bounds = fastpath.sort_records(*rec, *frame.size, frame.cfg)
        ox, oy, ckw = frame.composite_inputs(sf)
        loss = mean_sq_loss(frame.image(kc.composite(sf, bounds, ox, oy, **ckw)))
        cots["segsum"] = torch.autograd.grad(loss, f)[0]
    del table, prep, rec, sf, f
    bwd = {}
    for what, g in cots.items():
        d_got = kt.splat_table_bwd(inputs, view, vp, spec, g)
        d_plain = kt.splat_table_bwd_plain(inputs, view, vp, spec, g)
        leaves = {k: inputs[k].detach().requires_grad_(True) for k in diff_keys}
        with torch.enable_grad():
            fields = kt.splat_table_fwd_plain(dict(inputs, **leaves), view, vp, spec)[0]
            auto = dict(zip(diff_keys, torch.autograd.grad(
                fields, list(leaves.values()), g, allow_unused=True)))
        del fields, leaves
        errs, plain_errs, abs_err = {}, {}, 0.0
        for k in diff_keys:
            want = auto[k] if auto[k] is not None else torch.zeros_like(inputs[k])
            live = (g != 0).any(dim=0)        # autograd may give 0 * inf there
            want = torch.where(live.reshape((-1,) + (1,) * (want.dim() - 1)), want, 0)
            scale = float(want.abs().max()) or 1e-30
            assert bool(torch.isfinite(d_got[k]).all()), f"{name}: {k} gradient not finite"
            abs_err = max(abs_err, float((d_got[k] - want).abs().max()))
            errs[k] = float((d_got[k] - want).abs().max()) / scale
            plain_errs[k] = float((d_plain[k] - want).abs().max()) / scale
        log(f"[2] splat_table_bwd {name}, {what} cotangent: of each tensor's largest "
            f"gradient, kernel vs autograd {errs}; plain analytic vs autograd "
            f"{plain_errs}")
        assert max(errs.values()) <= BWD_ROW_TOL, (
            f"{name}: splat_table_bwd vs autograd ({what}): {errs}")
        bwd[what] = dict(max_abs_err=abs_err, max_rel_err=max(errs.values()), per_tensor=errs,
                         plain_max_rel_err=max(plain_errs.values()))
        del d_got, d_plain, auto
    g = cots["segsum"]
    ms = cuda_ms(lambda: kt.splat_table_bwd(inputs, view, vp, spec, g))
    dev_us = device_us(lambda: kt.splat_table_bwd(inputs, view, vp, spec, g), calls=20)
    pms = cuda_ms(lambda: kt.splat_table_bwd_plain(inputs, view, vp, spec, g))
    row = dict(max_abs_err=max(v["max_abs_err"] for v in bwd.values()), max_row_rel_err=max(v["max_rel_err"] for v in bwd.values()),
               cotangents=bwd, ms=ms, device_us=dev_us, plain_ms=pms, library_ms=None,
               splats=n, sh_row=sh_row, **table_bound(inputs, None, sh_row, backward=True))
    log(f"[2] splat_table_bwd {name}: kernel {ms:.4f} ms, on the device alone "
        f"{us(dev_us)} us, plain analytic {pms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return fwd, row


def check_radix(frame, results):
    """Kernels 6 and 7 on the uniform flagship frame's own packed keys: the
    counts of every pass and every pass of the sort against the plain
    versions, exactly, each timed between CUDA events and on the device
    alone; the whole sort, and the sort of the hoisted path's tile key,
    against torch.sort(stable=True), element for element."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    def us(v):
        return "not measured" if v is None else f"{v:.2f}"

    table, counts, ekw = frame.table()
    _, rec_t, rec_d = kr.expand(*table, ks.cumsum(counts), **ekw)
    del table
    key64 = kr.packed_key(rec_t, rec_d)         # as the torch.sort path holds it
    keys = kr.u32_bits(key64)                   # as the radix path holds it
    c, dev = keys.numel(), keys.device
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    bits, passes = rx.BITS, 32 // rx.BITS
    K = 1 << bits

    def same(got, ref, what):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
            f"radix_scatter {what}: differs from the plain version")

    def plain_pass(k, v, cnt, shift, b=bits):
        return rx.radix_scatter_plain(k, v, rx.chunk_offsets_plain(k, cnt, shift, b),
                                      shift, b)

    cnt = rx.radix_counts(keys, 32)
    assert torch.equal(cnt, rx.radix_counts_plain(keys, 32)), (
        "radix_counts differs from the plain version")
    cnt4 = rx.radix_counts(keys, 32, 4)
    assert torch.equal(cnt4, rx.radix_counts_plain(keys, 32, 4)), "radix_counts, 4 bits"
    counts_ms = cuda_ms(lambda: rx.radix_counts(keys, 32))
    counts_us = device_us(lambda: rx.radix_counts(keys, 32))
    counts_plain = cuda_ms(lambda: rx.radix_counts_plain(keys, 32))
    at = torch.cat([(keys >> (p * bits) & (K - 1)) + p * K for p in range(passes)])
    bincount = cuda_ms(lambda: torch.bincount(at, minlength=passes * K))
    del at
    k, v = keys, idx[None, :].contiguous()
    scat_ms, scat_us = [], []
    for p in range(passes):
        shift = p * bits
        got = rx.radix_scatter(k, v, cnt[p], shift)
        same(got, plain_pass(k, v, cnt[p], shift), f"pass {p}")
        scat_ms.append(cuda_ms(lambda: rx.radix_scatter(k, v, cnt[p], shift)))
        scat_us.append(device_us(lambda: rx.radix_scatter(k, v, cnt[p], shift)))
        if p == 0:
            scat_plain = cuda_ms(lambda: plain_pass(k, v, cnt[0], 0))
            # nine payload rows, and the 4-bit digit of the JAX package
            gen = torch.Generator(device=dev).manual_seed(8)
            v9 = torch.randn((9, c), generator=gen, device=dev).view(torch.int32)
            same(rx.radix_scatter(k, v9, cnt[0], 0), plain_pass(k, v9, cnt[0], 0),
                 "nine rows")
            nine_ms = cuda_ms(lambda: rx.radix_scatter(k, v9, cnt[0], 0))
            del v9
            same(rx.radix_scatter(k, v, cnt4[0], 0, 4), plain_pass(k, v, cnt4[0], 0, 4),
                 "4 bits")
        k, v = got
    rk, ri = torch.sort(key64, stable=True)
    assert torch.equal(kr.u32_values(k), rk) and torch.equal(v[0].to(torch.int64), ri), (
        "the radix passes differ from torch.sort(stable=True)")
    sk, (si,) = rx.radix_sort(keys, (idx,), 32)
    assert torch.equal(sk, k) and torch.equal(si, v[0]), (
        "radix_sort differs from its passes")
    whole = cuda_ms(lambda: rx.radix_sort(keys, (idx,), 32))
    whole_us = device_us(lambda: rx.radix_sort(keys, (idx,), 32))
    sort64 = cuda_ms(lambda: torch.sort(key64, stable=True))
    sort64_us = device_us(lambda: torch.sort(key64, stable=True))
    # the hoisted path's key: the tile id alone, which int32 holds
    kb = kr.tile_key_bits(frame.cfg.num_tiles)
    tile_passes = -(-kb // bits)
    st, (sti,) = rx.radix_sort(rec_t, (idx,), kb)
    rt, rti = torch.sort(rec_t, stable=True)
    assert torch.equal(st, rt) and torch.equal(sti.to(torch.int64), rti), (
        "radix_sort of the tile ids differs from torch.sort(stable=True)")
    whole_tile = cuda_ms(lambda: rx.radix_sort(rec_t, (idx,), kb))
    whole_tile_us = device_us(lambda: rx.radix_sort(rec_t, (idx,), kb))
    sort32 = cuda_ms(lambda: torch.sort(rec_t, stable=True))

    # counts: each key read once, the table written; a shift, a mask and an
    # add a key a pass. Scatter: key and one payload row read and written,
    # the pass's counts read; a shift, a mask and a rank a key. The whole
    # sort: the counts and every pass
    results["radix_counts"] = dict(
        max_abs_err=0.0, ms=counts_ms, device_us=counts_us, plain_ms=counts_plain,
        library_ms=bincount, library_is="torch.bincount of every pass's digit, offset "
        "by the pass", **bound(4 * c + 4 * passes * K, passes * c))
    # what a pass stores, key and payload row, over its device time: near the
    # memory rate only if runs of equal digits leave as whole sectors
    stored = 4 * c * (1 + v.shape[0])
    scat_gbs = [None if t is None else stored / (t * 1e-6) / 1e9 for t in scat_us]
    results["radix_scatter"] = dict(
        max_abs_err=0.0, ms=statistics.mean(scat_ms), pass_ms=scat_ms,
        device_us=(None if None in scat_us else statistics.mean(scat_us)),
        pass_device_us=scat_us, pass_stored_gb_per_s=scat_gbs, nine_rows_ms=nine_ms,
        nine_rows_stored_gb_per_s=40 * c / (nine_ms * 1e-3) / 1e9,
        plain_ms=scat_plain, library_ms=sort64,
        library_is="torch.sort(stable=True) of the int64 key: all passes at once",
        library_device_us=sort64_us,
        radix_sort=dict(ms=whole, device_us=whole_us, passes=passes,
                        **bound(4 * c + passes * 16 * c, (passes + 3 * passes) * c)),
        radix_sort_tile_key=dict(ms=whole_tile, device_us=whole_tile_us,
                                 passes=tile_passes, torch_sort_int32_ms=sort32,
                                 **bound(4 * c + tile_passes * 16 * c,
                                         4 * tile_passes * c)),
        **bound(16 * c + 4 * K, 3 * c))
    log(f"[2] radix_counts C={c} keys, {passes} passes of {bits} bits, one launch: "
        f"exact (and 4 bits); kernel {counts_ms:.4f} ms, on the device alone "
        f"{us(counts_us)} us, plain {counts_plain:.4f} ms, torch.bincount "
        f"{bincount:.4f} ms, bound {results['radix_counts']['bound_ms']:.4f} ms")
    log(f"[2] radix_scatter one payload row: every pass exact (and nine rows, and "
        f"4 bits, once); kernel ms a pass " + " ".join(f"{t:.4f}" for t in scat_ms)
        + "; on the device alone us a pass " + " ".join(us(t) for t in scat_us)
        + "; stored GB/s a pass " + " ".join(
            "not measured" if g is None else f"{g:.1f}" for g in scat_gbs)
        + f"; with nine rows {nine_ms:.4f} ms "
        f"({results['radix_scatter']['nine_rows_stored_gb_per_s']:.1f} GB/s stored), "
        f"plain {scat_plain:.4f} ms, bound "
        f"{results['radix_scatter']['bound_ms']:.4f} ms")
    log(f"[2] radix_sort of the {c} packed keys with the source index, equal to "
        f"torch.sort(stable=True) element for element: {whole:.4f} ms, on the device "
        f"alone {us(whole_us)} us (1 + {passes} launches, one clear; bound "
        f"{results['radix_scatter']['radix_sort']['bound_ms']:.4f} ms) against "
        f"torch.sort on the int64 key {sort64:.4f} ms, {us(sort64_us)} us; of the "
        f"tile ids alone ({kb} bits, {tile_passes} passes): {whole_tile:.4f} ms, "
        f"{us(whole_tile_us)} us against torch.sort on int32 {sort32:.4f} ms")


def record_sort_bound(c: int, key: str, num_tiles: int) -> dict:
    """``bound`` of the record sort stage's forward: the fields read and the
    sorted fields written (36 B each a record), the key words read (4 B a
    word), the inverse index written (4 B a record) and the bounds; a
    shift, a mask and a count a digit of a record a pass."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs

    lo_p, hi_p = rs.passes(num_tiles, key)
    words = 2 if key == "pair" else 1
    return bound(c * (76 + 4 * words) + 4 * (num_tiles + 1), 3 * (lo_p + hi_p) * c)


def check_record_sort(name, frame, keys=("pair", "packed")):
    """The record sort stage (kernels/record_sort.py) on the frame's own
    records, for each key: the expansion's sort words bit-equal to its
    plain version's; the kernels' sorted fields and bounds bit-equal to the
    plain stage (torch.sort of the int64 key, index_select, searchsorted)
    and their inverse index to the inverse of its source index; the
    un-sort bit-equal to index_copy_ in both cotangent modes. The forward
    and the un-sort timed between CUDA events and on the device alone, the
    forward launch by launch too, beside the plain stage and the library
    calls the stage replaced, call by call: torch.sort(stable=True) of the
    int64 key + index_select + searchsorted, and index_copy_. Returns {key:
    (forward row, un-sort row)}."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    def us(v):
        return "not measured" if v is None else f"{v:.1f}"

    table, counts, ekw = frame.table()
    cum = ks.cumsum(counts)
    t = frame.cfg.num_tiles
    rows = {}
    for key in keys:
        got = kr.expand(*table, cum, **ekw, key=key)
        ref = kr.expand_plain(*table, cum, **ekw, key=key)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), (
            f"{name}: the expansion's {key} outputs differ from the plain version")
        del ref
        rec_f, rec_t, rec_d, word = got
        words = rs.words_of(rec_t, rec_d, key, word)
        c, dev = rec_f.shape[1], rec_f.device
        sf, bounds, inv = rs.record_sort_fwd(rec_f, words, t, key)
        p_sf, p_bounds, si = rs.record_sort_plain(rec_f, words, t, key)
        assert torch.equal(sf, p_sf), f"{name} {key}: sorted fields differ from the plain stage"
        assert torch.equal(bounds, p_bounds), f"{name} {key}: bounds differ from searchsorted"
        assert torch.equal(inv, rs.inverse_plain(si)), f"{name} {key}: the inverse index differs"
        # a frame without a gradient: the same outputs, no inverse stored
        n_sf, n_bounds, n_inv = rs.record_sort_fwd(rec_f, words, t, key, inverse=False)
        assert n_inv is None and torch.equal(n_sf, sf) and torch.equal(n_bounds, bounds)
        del sf, p_sf, p_bounds, n_sf, n_bounds

        def fwd():
            return rs.record_sort_fwd(rec_f, words, t, key)

        def fwd_frame():
            return rs.record_sort_fwd(rec_f, words, t, key, inverse=False)

        k64 = rs.key64(words, key)
        sk, _ = torch.sort(k64, stable=True)
        bnd = (torch.arange(t + 1, dtype=torch.int64, device=dev)
               << (32 if key == "pair" else kr.PACKED_DEPTH_BITS))
        parts = {"int64 key": lambda: rs.key64(words, key),
                 "torch.sort": lambda: torch.sort(k64, stable=True),
                 "index_select": lambda: rec_f.index_select(1, si),
                 "searchsorted": lambda: torch.searchsorted(sk, bnd)}
        plain_parts = {k: (cuda_ms(fn, reps=9), device_us(fn, calls=20))
                       for k, fn in parts.items()}

        def library():
            return parts["torch.sort"](), parts["index_select"](), parts["searchsorted"]()

        lo_p, hi_p = rs.passes(t, key)
        f_row = dict(
            max_abs_err=0.0, ms=cuda_ms(fwd, reps=9), device_us=device_us(fwd, calls=20),
            launches_device_us=device_launches(fwd),
            no_inverse_ms=cuda_ms(fwd_frame, reps=9),
            no_inverse_device_us=device_us(fwd_frame, calls=20),
            plain_ms=cuda_ms(lambda: rs.record_sort_plain(rec_f, words, t, key), reps=9),
            plain_parts_ms_device_us=plain_parts,
            library_ms=cuda_ms(library, reps=9), library_device_us=device_us(library, calls=20),
            library_is="torch.sort(stable=True) of the int64 key + index_select of the "
            "nine rows + searchsorted", key=key, records=c, binned=int(bounds[-1]), tiles=t,
            passes=lo_p + hi_p, **record_sort_bound(c, key, t))
        del k64, sk

        gen = torch.Generator(device=dev).manual_seed(6)
        g = torch.randn((kr.NUM_FIELDS, c), generator=gen, device=dev)
        mode = kr.BWD_COT_PACK
        try:
            for cot in ("f32", "bf16"):
                kr.BWD_COT_PACK = cot
                assert torch.equal(rs.record_unsort(g, inv),
                                   rs.unsort_plain(g, si, rs._paired(None))), (
                    f"{name} {key}: the un-sort differs from index_copy_ "
                    f"({kr.BWD_COT_PACK} cotangents)")
        finally:
            kr.BWD_COT_PACK = mode

        def copy():
            return torch.empty_like(g).index_copy_(1, si, g)

        b_row = dict(
            max_abs_err=0.0, ms=cuda_ms(lambda: rs.record_unsort(g, inv), reps=9),
            device_us=device_us(lambda: rs.record_unsort(g, inv), calls=20),
            plain_ms=cuda_ms(lambda: rs.unsort_plain(g, si), reps=9),
            library_ms=cuda_ms(copy, reps=9), library_device_us=device_us(copy, calls=20),
            library_is="index_copy_ of the nine rows by the source index", key=key,
            records=c, **bound(76 * c, 0))
        log(f"[2] record_sort {name}, {key} key: C={c} records, {t} tiles, "
            f"{lo_p + hi_p} passes; sorted fields, bounds and inverse bit-equal to the "
            f"plain stage; kernels {f_row['ms']:.4f} ms, on the device alone "
            f"{us(f_row['device_us'])} us (without the inverse, as a frame without a "
            f"gradient: {f_row['no_inverse_ms']:.4f} ms, "
            f"{us(f_row['no_inverse_device_us'])} us; by launch: "
            + ", ".join(f"{n.split('(')[0][-22:]} {v:.1f}"
                        for n, v in (f_row["launches_device_us"] or []))
            + f"), plain {f_row['plain_ms']:.4f} ms (by call, ms / device us: "
            + ", ".join(f"{k} {a:.4f} / {us(b)}" for k, (a, b) in plain_parts.items())
            + f"), library {f_row['library_ms']:.4f} ms / {us(f_row['library_device_us'])} "
            f"us, bound {f_row['bound_ms']:.4f} ms; un-sort bit-equal to index_copy_ "
            f"(f32 and bf16 cotangents): {b_row['ms']:.4f} ms, on the device alone "
            f"{us(b_row['device_us'])} us, plain {b_row['plain_ms']:.4f} ms, index_copy_ "
            f"{b_row['library_ms']:.4f} ms / {us(b_row['library_device_us'])} us, bound "
            f"{b_row['bound_ms']:.4f} ms")
        rows[key] = (f_row, b_row)
        del got, rec_f, rec_t, rec_d, word, words, g, inv, si
    return rows


def check_sort_routes(frame, img):
    """Phase [3]: the default frame and its gradients through the record
    sort kernels and through the plain stage (``plain_record_sort``), bit
    for bit, each timed; the device records of one forward + backward on
    the kernels hold none of the library calls the stage replaced
    (``LIBRARY_SORT_NAMES``), and those of the plain stage do."""
    import torch

    with plain_record_sort():
        img_p, _ = frame.render()
    assert torch.equal(img, img_p), "the default frame differs between the sort routes"
    with torch.enable_grad():
        g_k, _ = frame.grads(mean_sq_loss)
        with plain_record_sort():
            g_p, _ = frame.grads(mean_sq_loss)
        for k in g_k:
            assert torch.equal(g_k[k], g_p[k]), f"the {k} gradient differs between the sort routes"
        del g_k, g_p

        def fb():
            return frame.grads(mean_sq_loss)

        nums = {"frame_ms": cuda_ms(frame.render),
                "fwdbwd_ms": cuda_ms(fb, reps=3, warmup=1)}
        names_k = device_names(fb)
        with plain_record_sort():
            nums["plain_stage_frame_ms"] = cuda_ms(frame.render)
            nums["plain_stage_fwdbwd_ms"] = cuda_ms(fb, reps=3, warmup=1)
            names_p = device_names(fb)

    def hits(names):
        return sorted(n[:100] for n in names
                      if any(p in n.lower() for p in LIBRARY_SORT_NAMES))

    assert hits(names_p), "no library sort kernel recognised on the plain stage"
    assert not hits(names_k), f"library sort kernels on the kernel stage: {hits(names_k)}"
    nums["plain_stage_library_kernels"] = hits(names_p)
    log(f"[3] uniform pair frame and gradients bit-equal on the record sort kernels and "
        f"on the plain stage; frame {nums['frame_ms']:.3f} ms (plain stage "
        f"{nums['plain_stage_frame_ms']:.3f}), forward + backward {nums['fwdbwd_ms']:.3f} "
        f"ms (plain stage {nums['plain_stage_fwdbwd_ms']:.3f}); device kernels of one "
        f"forward + backward: {len(names_k)} names, none of torch.sort, index_select, "
        f"searchsorted, index_copy_ (the plain stage's: {nums['plain_stage_library_kernels']})")
    return nums


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
    dev_us = device_us(lambda: bp.bucketer_level(rec, BUCKET_K), calls=10)
    pms = cuda_ms(lambda: bp.bucketer_level_plain(rec, BUCKET_K), reps=3, warmup=1)
    n_chunks = BUCKET_C // bp.R
    # 64 B a record read; 16 x 128 x 4 B a bucket a chunk written
    results["bucketer_level"] = dict(
        max_abs_err=0.0, ms=ms, device_us=dev_us, plain_ms=pms, library_ms=None,
        probe_ms=probe["bucketer_level_lower_bound_ms"],
        **bound(4 * bp.ROWS * BUCKET_C + 4 * bp.ROWS * bp.CARRY * BUCKET_K * n_chunks,
                3 * BUCKET_C))
    written = 4 * bp.ROWS * bp.CARRY * BUCKET_K * n_chunks
    log(f"[2] bucketer_level exact on 64 chunks; probe {json.dumps(probe)}; at "
        f"C={BUCKET_C}, K={BUCKET_K}: kernel {ms:.4f} ms, on the device alone "
        + ("not measured" if dev_us is None else
           f"{dev_us:.1f} us ({written / (dev_us * 1e-6) / 1e9:.1f} GB/s written)")
        + f", plain {pms:.4f} ms, bound {results['bucketer_level']['bound_ms']:.4f} ms")
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
    # events around one call read the host's dispatch at this size, and so do
    # 40 calls back to back where the call's Python outlasts its kernel; the
    # profiler's kernel records read the device alone
    large = dict(n=LARGE_AFFINE, ms=cuda_ms(lambda: cp.probe_affine(big)),
                 library_ms=cuda_ms(lambda: torch.add(one, big, alpha=2.0)),
                 running_ms=cuda_ms_running(lambda: cp.probe_affine(big)),
                 library_running_ms=cuda_ms_running(
                     lambda: torch.add(one, big, alpha=2.0)),
                 device_us=device_us(lambda: cp.probe_affine(big)),
                 library_device_us=device_us(lambda: torch.add(one, big, alpha=2.0)),
                 **bound(8 * LARGE_AFFINE, 2 * LARGE_AFFINE))
    results["probe_affine"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lms,
                                   **bound(8 * x.numel(), 2 * x.numel()), large=large)
    def us(v):
        return "not measured" if v is None else f"{v:.3f}"

    reset_launches()
    cache = cp.run()
    launches["probe_affine"] = read_launches()["probe_affine"]
    log(f"[2] probe_affine exact at (8, 128) and 1,000,003 values; kernel {ms:.4f} "
        f"ms, plain {pms:.4f} ms, torch.add(alpha=2) {lms:.4f} ms; at "
        f"{LARGE_AFFINE} values kernel {large['ms']:.4f} ms, torch.add "
        f"{large['library_ms']:.4f} ms, 40 calls back to back "
        f"{large['running_ms']:.4f} ms a call, torch.add "
        f"{large['library_running_ms']:.4f}, on the device alone (profiler, us a call) "
        f"{us(large['device_us'])} against {us(large['library_device_us'])}, bound "
        f"{large['bound_ms']:.4f} ms; build-cache "
        f"probe {json.dumps(cache)}")
    return launches


def check_single_key_frames(frame, img_pair, img_packed):
    """The uniform flagship frame through the single-key record sorts. Each
    configuration renders once with the launch counts at 0, then is checked
    and timed. Returns {name: launch counts of that one frame}."""
    import dataclasses

    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
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
        # the packed key's f32 sort is the record sort stage on either route:
        # one count, a scatter a pass (four at the flagship's 512 tiles), one
        # gather; the hoisted radix route counts once and scatters a pass of
        # the tile id (two); q16 and the hoisted lax route run torch.sort
        if name == "packed+radix":
            want = (0, 0, 2 + sum(rs.passes(cfg.num_tiles, "packed")))
        elif cfg.record_sort == "radix":
            want = (1, rx.passes_of(kr.tile_key_bits(cfg.num_tiles), rx.BITS), 0)
        else:
            want = (0, 0, 0)
        got = tuple(counts[name][k] for k in ("radix_counts", "radix_scatter", "record_sort"))
        assert got == want, (f"uniform {name}: radix and record sort launches {got}, "
                             f"not {want}")
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


def load_script(name):
    """A script of ``scripts/`` loaded as a module, by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gate_divergence():
    """The float64 replay of ``scripts/torch_gate_divergence.py``."""
    return load_script("torch_gate_divergence")


def flips(findings):
    """[pixel, diff, [(record, branch, margin), ...]] of each replayed pixel."""
    return [(f["px"], f["diff"], [(c["record"], c["branch"], c["margin"])
                                  for c in f["culprits"]]) for f in findings]


def oracle_render(frame, **kw):
    """(image, stats, ms between CUDA events, seconds on the host's clock)
    of one oracle frame, with no kernel launched."""
    import dataclasses

    import torch

    f = frame.with_cfg(dataclasses.replace(frame.cfg, use_pallas=False, **kw))
    reset_launches()
    t0 = time.perf_counter()
    (img, stats), ms = cuda_ms_once(f.render)
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in read_launches().items() if v}
    assert not launched, f"the oracle launched kernels: {launched}"
    torch.cuda.synchronize()
    assert int(stats["overflow"]) == 0 and int(stats["dropped_by_cap"]) == 0, (
        f"oracle overflow {int(stats['overflow'])}, dropped by the cap "
        f"{int(stats['dropped_by_cap'])}")
    return img, stats, ms, seconds


def check_oracle(gate, flag):
    """Phase [3a]: the kernels against the oracle on the card. Returns
    (the kernels' launch counts in this phase, the phase's numbers)."""
    import dataclasses

    import torch

    from openglgaussiansplattingrenderer_tpu_torch.render import render_depth

    gd = gate_divergence()
    gate = gate.with_cfg(dataclasses.replace(gate.cfg, max_per_tile=2048))
    out = {}
    reset_launches()
    with torch.no_grad():
        img_k, _ = gate.render()
        d_k, a_k, _ = render_depth(gate.params, *gate.args, gate.cfg)
    g_k, _ = gate.grads(mean_sq_loss)
    with torch.no_grad():
        f_img_k, f_st = flag.render()
    torch.cuda.synchronize()
    launches = read_launches()
    for k in STEP_KERNELS:
        assert launches[k] > 0, f"{k} kernel never launched in the oracle phase"

    # ---- the gate scene's frame
    with torch.no_grad():
        img_o, _, ms, _ = oracle_render(gate)
    gate_stream = gd.Stream(gate.params, gate.args, gate.cfg)
    err, bad = gd.bad_pixels(img_k, img_o)
    found = gd.attribute(gate_stream, bad, gate.cfg)
    explained = sum(f["explained"] for f in found)
    out["gate"] = dict(max_abs=err, px_above_1e3=len(bad), explained=explained,
                       oracle_ms=ms, flips=flips(found))
    log(f"[3a] gate scene, kernels vs oracle: max abs {err:.3e}, {len(bad)} px > 1e-3 "
        f"(limits {GATE_MAX_ABS}, {GATE_MAX_PX}); the float64 replay explains "
        f"{explained} of them: {out['gate']['flips']}; oracle frame {ms:.2f} ms")
    if err > ATTRIBUTED_DIFF or len(bad) > ATTRIBUTED_PX:
        log(f"[3a] WARNING: the gate at {err:.2e} / {len(bad)} px is past the "
            f"attributed point ({ATTRIBUTED_DIFF:.1e} / {ATTRIBUTED_PX} px): "
            "attribute it with scripts/torch_gate_divergence.py before accepting "
            "further drift")
    assert err <= GATE_MAX_ABS and len(bad) <= GATE_MAX_PX, (
        f"gate scene: the kernels diverge from the oracle: max abs {err:.3e}, "
        f"{len(bad)} px > 1e-3 (scripts/torch_gate_divergence.py attributes them)")

    # ---- its gradients: kernels 3 and 5 against autograd through the oracle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    oracle = gate.with_cfg(dataclasses.replace(gate.cfg, use_pallas=False))
    reset_launches()
    g_o, _ = oracle.grads(mean_sq_loss)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    assert not any(read_launches().values()), "the oracle's backward launched kernels"
    peak = torch.cuda.max_memory_allocated()
    rel = {k: float((g_k[k] - g_o[k]).abs().max() / g_o[k].abs().max().clamp_min(1e-30))
           for k in g_o}
    del g_o
    torch.cuda.empty_cache()
    out["gate_grads"] = dict(max_rel=rel, oracle_s=grad_s, peak_gb=peak / 2 ** 30)
    log("[3a] gate scene gradients of mean(img[..., :3]**2), kernels vs oracle "
        "autograd, max abs / max |g|: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (limit {GRAD_REL_TOL}); oracle forward + backward {grad_s:.2f} s, "
        f"peak {peak / 2 ** 30:.2f} GiB allocated")
    assert max(rel.values()) <= GRAD_REL_TOL, "gate scene: gradients disagree"

    # ---- its depth maps, outside the pixels a threshold flip names
    with torch.no_grad():
        d_o, a_o, _ = render_depth(gate.params, *gate.args, oracle.cfg)
    off = ((d_k - d_o).abs() > DEPTH_TOL) | ((a_k - a_o).abs() > DEPTH_ALPHA_TOL)
    ys, xs = (v.tolist() for v in torch.nonzero(off, as_tuple=True))
    named = sum(bool(gd.borderline(gate_stream.records(gate_stream.tile_of(x, y))[1],
                                   x, y, gate.cfg)) for x, y in zip(xs, ys))
    keep = ~off
    depth_err = float((d_k - d_o).abs()[keep].max())
    alpha_err = float((a_k - a_o).abs()[keep].max())
    out["gate_depth"] = dict(max_abs_depth=depth_err, max_abs_alpha=alpha_err,
                             flipped_px=len(xs), named=named)
    log(f"[3a] gate scene depth maps (ndc), kernels vs oracle: {len(xs)} px beyond "
        f"{DEPTH_TOL} / {DEPTH_ALPHA_TOL}, {named} of them named by the replay; "
        f"elsewhere depth {depth_err:.3e}, alpha {alpha_err:.3e}")
    assert named == len(xs), "gate depth maps differ where no threshold flip is named"
    del gate_stream, d_k, a_k, d_o, a_o

    # ---- the uniform flagship's forward frame
    w, h = flag.size
    with torch.no_grad():
        # one chunk gives the oracle's own largest bin (it keeps the records
        # the kernels' expansion culls); then every record of every tile
        _, st1 = flag.with_cfg(dataclasses.replace(
            flag.cfg, use_pallas=False, max_per_tile=flag.cfg.chunk)).render()
        max_bin = int(st1["max_bin"])
        mpt = -(-max_bin // flag.cfg.chunk) * flag.cfg.chunk
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        img_o, _, ms, seconds = oracle_render(flag, max_per_tile=mpt)
        peak = torch.cuda.max_memory_allocated()
        err, bad = gd.bad_pixels(f_img_k, img_o)
        limit_px = int(ORACLE_FLAG_PX_SHARE * w * h)
        found = gd.attribute(gd.Stream(flag.params, flag.args, flag.cfg), bad, flag.cfg)
    explained = sum(f["explained"] for f in found)
    borderline = sum(bool(f["culprits"]) for f in found)
    out["flagship"] = dict(max_abs=err, px_above_1e3=len(bad), explained=explained,
                           borderline=borderline, oracle_max_bin=max_bin,
                           max_per_tile=mpt, chunks=mpt // flag.cfg.chunk,
                           oracle_ms=ms, oracle_s=seconds, peak_gb=peak / 2 ** 30,
                           flips=flips(found))
    log(f"[3a] uniform flagship ({FLAG_SPLATS} splats, {w}x{h}), kernels vs oracle: "
        f"max abs {err:.3e}, {len(bad)} px > 1e-3 (limits {ORACLE_FLAG_TOL}, "
        f"{limit_px}); {borderline} of them with a record within the replay's "
        f"FLIP_EPS of a branch, {explained} explained by its flip; the oracle's "
        f"largest bin {max_bin} (the kernels' {int(f_st['max_bin'])}) -> max_per_tile "
        f"{mpt}, {mpt // flag.cfg.chunk} chunks: {ms:.1f} ms between events, "
        f"{seconds:.2f} s on the host's clock, peak {peak / 2 ** 30:.2f} GiB allocated; "
        f"{out['flagship']['flips']}")
    assert err <= ORACLE_FLAG_TOL and len(bad) <= limit_px, (
        f"uniform flagship: the kernels diverge from the oracle: max abs {err:.3e}, "
        f"{len(bad)} px > 1e-3")
    del img_o, f_img_k
    torch.cuda.empty_cache()
    return launches, out


def check_composite(name, frame, plain_once=False, records=None):
    """Kernels 4 and 5 on the frame's own sorted records (or on ``records``,
    (sorted fields, bounds) of the frame), with a seeded cotangent and each
    backward fed its own forward's output. The plain versions are timed as
    the kernels are, or with ``plain_once`` by the one call that makes the
    reference. Returns the two kernels' result rows."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc

    sf, bounds = records if records is not None else frame.sorted_records()
    ox, oy, kw = frame.composite_inputs(sf)
    got = kc.composite(sf, bounds, ox, oy, **kw)
    pairs = {}
    ref, pms = cuda_ms_once(
        lambda: kc.composite_plain(sf, bounds, ox, oy, **kw, pair_counts=pairs))
    visited, blended = int(pairs["visited"]), int(pairs["blended"])
    err, bad = image_diff(frame.image(got), frame.image(ref))
    assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
        f"{name}: compositor vs plain: max abs {err:.3e}, {bad} px > 1e-3")
    ms = cuda_ms(lambda: kc.composite(sf, bounds, ox, oy, **kw))
    if not plain_once:
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
    d_ref, pms = cuda_ms_once(
        lambda: kc.composite_bwd_plain(sf, bounds, ox, oy, ref, g, **kw))
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
    if not plain_once:
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
    of the steps and the median step wall time (ms)."""
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
    # the same steps from the same start on the plain record sort stage:
    # the losses bit for bit
    with torch.no_grad():
        plain_state = step.init(raw_from_params(start.params))
    plain_hist = []
    with plain_record_sort():
        for _ in range(TRAIN_STEPS):
            plain_state, plain_metrics = step(plain_state, target, *frame.args[:6])
            plain_hist.append(float(plain_metrics["loss"]))
    assert plain_hist == loss_hist, (
        f"training losses differ between the sort routes: {loss_hist} vs {plain_hist}")
    del plain_state, plain_metrics

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
    for k in STEP_KERNELS:
        assert launches[k] > 0, f"{k} kernel never launched on the training path"
    for k in ("splat_table", "splat_table_bwd", "record_unsort"):
        assert launches[k] == TRAIN_STEPS, f"{k}: {launches[k]} launches in {TRAIN_STEPS} steps"
    assert launches["record_sort"] > 0, "the record sort stage never launched in training"
    log(f"[5] training, {n} splats at {w}x{h}, {TRAIN_STEPS} steps of "
        f"make_train_step (lambda_dssim {tc.lambda_dssim}, grad norms): loss "
        + " ".join(f"{v:.6f}" for v in loss_hist)
        + "; psnr " + " ".join(f"{v:.3f}" for v in psnr_hist)
        + f"; step wall ms {' '.join(f'{v:.1f}' for v in wall)} (median "
        f"{statistics.median(wall):.3f}); the same losses bit for bit on the plain "
        f"record sort stage; forward + backward {fb_ms:.3f} ms; "
        f"largest colour move {moved:.4f}; overflow {overflow}")
    log(f"[5] kernel launches on the training path: {launches}")
    return launches, statistics.median(wall)


def check_densify(frame, cam, unpadded_step_ms):
    """Phase [5b]: ``fit_scene_adaptive`` on the uniform flagship with
    perturbed colours against its clean render, padded to
    ``DENSIFY_CAPACITY`` rows. Checks the padded start's frame against the
    unpadded one under both ``tight_rect`` settings, times the train step
    at capacity and ``densify_and_prune`` there, then drives the fit with
    the counters reset just before and read just after. Returns them."""
    import dataclasses

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.render import (
        autotune_capacity,
        render_arrays,
    )
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        params_from_raw,
        raw_from_params,
    )

    w, h = frame.size
    cap = DENSIFY_CAPACITY
    with torch.no_grad():
        target = frame.render()[0][..., :3].contiguous()
    colors = frame.params["colors"].cpu().numpy()
    noisy = np.clip(colors + np.random.default_rng(0).normal(0, 40, colors.shape),
                    5, 250).astype(np.float32)
    start = dict(frame.params, colors=torch.as_tensor(noisy).to(target.device))
    means = start["means"].cpu().numpy()
    extent = float(np.abs(means - means.mean(axis=0)).max())   # as train_cli.py

    # the padded start renders the unpadded frame bit for bit; its dead rows
    # get no record under tight_rect and a culled one without it
    cfgs = {}
    with torch.no_grad():
        raw = raw_from_params(start)
        padded, alive = dn.pad_to_capacity(raw, cap)
        p_un, p_pad = params_from_raw(raw), params_from_raw(padded)
        for tight in (True, False):
            cfg = autotune_capacity(p_pad, *frame.args[:6], w, h,
                                    dataclasses.replace(frame.cfg, tight_rect=tight))
            cfgs[tight] = cfg
            img_u, st_u = render_arrays(p_un, *frame.args, cfg)
            img_p, st_p = render_arrays(p_pad, *frame.args, cfg)
            st_u = {k: int(v) for k, v in st_u.items()}
            st_p = {k: int(v) for k, v in st_p.items()}
            live_u = st_u["num_records"] - st_u["culled_unreachable"]
            live_p = st_p["num_records"] - st_p["culled_unreachable"]
            dead_on_screen = st_p["num_visible"] - st_u["num_visible"]
            extra_culled = st_p["culled_unreachable"] - st_u["culled_unreachable"]
            log(f"[5b] padded start ({cap} rows, {cap - st_u['num_splats']} dead) vs "
                f"unpadded, tight_rect={tight}: bit-equal {torch.equal(img_u, img_p)}; "
                f"records {st_u['num_records']} -> {st_p['num_records']}, live "
                f"{live_u} -> {live_p}, culled {st_u['culled_unreachable']} -> "
                f"{st_p['culled_unreachable']}; dead rows on screen {dead_on_screen}; "
                f"capacity {cfg.capacity_records}; overflow {st_p['overflow']}")
            assert torch.equal(img_u, img_p), f"tight_rect={tight}: the padded frame differs"
            assert live_u == live_p, f"tight_rect={tight}: live records {live_u} -> {live_p}"
            assert st_p["overflow"] == 0 and st_u["overflow"] == 0
            if tight:
                assert st_p["num_records"] == st_u["num_records"], "dead rows allocated"
            else:
                assert dead_on_screen > 0 and extra_culled >= dead_on_screen, (
                    f"the cull dropped {extra_culled} records of {dead_on_screen} "
                    "dead rows on screen")
        del p_un, p_pad, img_u, img_p
    cfg = cfgs[True]

    # steps 0-4 at capacity, as the fit takes them: their statistic sets the
    # threshold (DENSIFY_SHARE of the live splats) the densify at step 4 reads
    tc = TrainConfig(steps=DENSIFY_STEPS, lambda_dssim=0.2)
    step = make_train_step(cfg, tc, w, h, with_grad_norms=True, grad_stat="screen",
                           param_keys=tuple(sorted(padded)))
    state = step.init(padded)
    accum = torch.zeros(cap, device=target.device)
    seen = torch.zeros(cap, device=target.device)
    wall = []
    for _ in range(DENSIFY_START + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, target, *frame.args[:6])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        accum, seen = dn.accumulate_grad_stats(accum, seen, metrics["densify_grad_norm"],
                                               alive)
    live_avg = (accum / seen.clamp_min(1.0))[alive & (seen > 0)]
    k = int(int(alive.sum()) * DENSIFY_SHARE)
    thr = float(torch.topk(live_avg, k + 1).values[-1])
    n_default = int((live_avg > 2e-4).sum())
    log(f"[5b] train step at capacity ({cap} rows), wall ms "
        f"{' '.join(f'{v:.1f}' for v in wall)} (median {statistics.median(wall):.3f}; "
        f"phase [5]'s unpadded step {unpadded_step_ms:.3f}); grad_threshold "
        f"{thr:.4e} picks {int((live_avg > thr).sum())} of {int(alive.sum())} live "
        f"splats ({live_avg.numel()} seen); the default 2e-4 would pick {n_default}")

    dc = dn.DensifyConfig(capacity=cap, grad_threshold=thr, percent_dense=DENSIFY_PERCENT,
                          scene_extent=extent, start_step=DENSIFY_START,
                          interval=DENSIFY_INTERVAL, stop_step=DENSIFY_STEPS,
                          opacity_reset_interval=DENSIFY_RESET)
    gen = torch.Generator(device=target.device).manual_seed(0)

    def densify_once():
        return dn.densify_and_prune(state.raw, alive, accum, seen, dc, generator=gen)

    d_ms = cuda_ms(densify_once)
    # one call a profiled run: a run of several holds a few more elementwise
    # kernels than that many single calls, and device_us counts only a
    # run that holds exactly its calls' records
    d_us = device_us(densify_once, calls=1)
    d_stats = {k: int(v) for k, v in densify_once()[3].items()}
    log(f"[5b] densify_and_prune at {cap} rows: {d_ms:.3f} ms between events (median "
        f"of {REPS}), on the device alone "
        f"{'not measured' if d_us is None else f'{d_us:.1f} us'}; {d_stats}")
    del state, metrics, accum, seen, padded, raw

    events = []

    def on_densify(i, before, after, stats):
        saved = read_launches()        # the checks' frames are not the fit's
        with torch.no_grad():
            st = [{k: int(v) for k, v in render_arrays(params_from_raw(r), *frame.args,
                                                        cfg)[1].items()}
                  for r in (before[0], after[0])]
        for k, fn in kernel_wrappers().items():
            fn.launches = saved[k]
        dead = ~after[1]
        parked = (bool((after[0]["logit_opacities"][dead] == dn.DEAD_LOGIT).all())
                  and bool((after[0]["log_scales"][dead] == dn.DEAD_LOG_SCALE).all()))
        events.append({"step": i, **{k: int(v) for k, v in stats.items()},
                       "alive_before": int(before[1].sum()),
                       "alive_after": int(after[1].sum()), "parked": parked,
                       "records_before": st[0]["num_records"],
                       "records_after": st[1]["num_records"],
                       "overflow_after": st[1]["overflow"]})

    reset_launches()
    t0 = time.perf_counter()
    fitted, alive_end, hist = dn.fit_scene_adaptive(
        start, [target], [cam], cfg, dc, tc=tc, log_every=1, verbose=False,
        device=target.device, on_densify=on_densify)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    with torch.no_grad():
        end_overflow = int(render_arrays(fitted, *frame.args, cfg)[1]["overflow"])

    losses = [e["loss"] for e in hist]
    for e in events:
        log(f"[5b] densify at step {e['step']}: {e}")
    log(f"[5b] fit_scene_adaptive, {DENSIFY_STEPS} steps in {fit_s:.2f} s: loss "
        + " ".join(f"{v:.6f}" for v in losses) + "; psnr "
        + " ".join(f"{e['psnr']:.3f}" for e in hist) + "; alive "
        + " ".join(str(e["alive"]) for e in hist)
        + f"; overflow at the end {end_overflow}")
    log(f"[5b] kernel launches on the densify path: {launches}")
    assert [e["step"] for e in hist] == list(range(DENSIFY_STEPS)), hist
    assert all(np.isfinite(losses)), losses
    # Before the opacity reset the loss falls at every step that no densify
    # precedes. A densify moves the image: the threshold picks 1% of the
    # live splats, but only the few percent in front get a gradient at all,
    # so the clones and splits rewrite a large share of the visible ones.
    after_densify = {e["step"] + 1 for e in events}
    for i in range(1, DENSIFY_RESET):
        if i not in after_densify:
            assert losses[i] < losses[i - 1], (
                f"loss did not fall at step {i} before the opacity reset: {losses}")
    log("[5b] loss change across each densify: " + ", ".join(
        f"step {i - 1} -> {i}: {losses[i] - losses[i - 1]:+.6f}"
        for i in sorted(after_densify)))
    assert [e["step"] for e in events] == list(range(DENSIFY_START, DENSIFY_STEPS,
                                                     DENSIFY_INTERVAL)), events
    assert sum(e["cloned"] for e in events) > 0, "densify cloned nothing"
    assert sum(e["split"] for e in events) > 0, "densify split nothing"
    for e in events:
        assert e["alive_after"] == e["alive"] == (
            e["alive_before"] + e["cloned"] + e["split"] - e["pruned"]), e
        assert e["parked"], f"step {e['step']}: a dead row is not parked at -20"
        assert e["overflow_after"] == 0, e
    assert end_overflow == 0, f"overflow {end_overflow} at the end"
    assert int(alive_end.sum()) == hist[-1]["alive"]
    for k in STEP_KERNELS:
        assert launches[k] > 0, f"{k} kernel never launched on the densify path"
    return launches


def check_cli(ply, device):
    """Phase [5b], continued: ``scripts/torch_train_cli.py`` in-process on
    the card through two routes, counters reset just before each run and
    read just after: the PLY route on the uniform flagship's PLY ``ply``
    (CLI_VIEWS orbit views at 1024x512, CLI_STEPS steps, --densify) and the
    COLMAP route on a small workspace written here as
    tests/test_colmap.py writes its fixture. Returns the counts of each."""
    import json
    import os
    import tempfile

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import colmap as cm
    from openglgaussiansplattingrenderer_tpu_torch.io import dataset as ds
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
    from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays

    cli = load_script("torch_train_cli")
    out = {}

    def run(name, argv, d):
        files = [os.path.join(d, f"{name}{ext}") for ext in (".ply", ".png", ".json")]
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", files[0], "--out-png", files[1],
                              "--history", files[2]])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[name] = read_launches()
        assert rc == 0, f"the CLI's {name} route exited {rc}"
        assert all(os.path.exists(f) for f in files), f"the {name} route's outputs"
        hist = json.load(open(files[2]))
        psnr = hist["final_psnr_view0"]
        assert np.isfinite(psnr), f"{name} route: PSNR {psnr}"
        steps = hist["history"]
        log(f"[5b] CLI {name} route: exit {rc} in {seconds:.1f} s; losses "
            + " ".join(f"{e['step']}:{e['loss']:.5f}" for e in steps)
            + f"; {hist['splats']} splats written; view-0 PSNR {psnr:.3f} dB; "
            f"launches {out[name]}")
        for k in STEP_KERNELS:
            assert out[name][k] > 0, f"{k} kernel never launched by the {name} route"

    with tempfile.TemporaryDirectory() as d:
        run("ply", [ply, "--width", str(FLAG_W), "--height", str(FLAG_H),
                    "--views", str(CLI_VIEWS), "--orbit-radius", "8", "--steps",
                    str(CLI_STEPS), "--densify", "--densify-start", "5",
                    "--densify-interval", "5", "--log-every", "5"], d)

        # a COLMAP workspace: two posed 64x64 views of a 40-splat scene
        w = h = 64
        small = ply_io.make_synthetic_scene(40, seed=6, extent=1.0)
        sparse, images = os.path.join(d, "ws", "sparse", "0"), os.path.join(d, "ws", "images")
        os.makedirs(sparse)
        os.makedirs(images)
        cm.write_cameras_bin(os.path.join(sparse, "cameras.bin"), {1: {
            "model": "PINHOLE", "width": w, "height": h,
            "params": np.array([70.0, 70.0, w / 2.0, h / 2.0])}})
        poses, names = [], []
        cfg = RenderConfig.for_resolution(w, h, tile_px=32, chunk=64,
                                          dup_capacity_factor=32.0)
        params = params_from_numpy({k: v for k, v in small.items() if k != "sh_rest"},
                                   device)
        for i, (pos, yaw) in enumerate((([0, 0, 4.0], 0.0), ([1.2, 0, 3.8], 17.0))):
            a = np.deg2rad(yaw)
            c2w = np.eye(4)
            c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
            c2w[:3, 3] = pos
            w2c = np.linalg.inv(c2w @ np.diag([1.0, -1.0, -1.0, 1.0]))
            poses.append((cm.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3]))
            b = ds.bundle_from_c2w(c2w, w, h, fl_x=70.0, fl_y=70.0)
            with torch.no_grad():
                img, _ = render_arrays(params, b["view"], b["vp"], b["focal_x"],
                                       b["focal_y"], b["tan_fovx"], b["tan_fovy"], w, h,
                                       cfg)
            arr = img[..., :3].cpu().numpy()
            assert arr.max() > 0.02, "the COLMAP view does not see the scene"
            names.append(f"v{i}.png")
            save_png(os.path.join(images, names[-1]), arr)
        cm.write_images_bin(os.path.join(sparse, "images.bin"), [
            {"image_id": i + 1, "qvec": q, "tvec": t, "camera_id": 1, "name": names[i]}
            for i, (q, t) in enumerate(poses)])
        cm.write_points3d_bin(os.path.join(sparse, "points3D.bin"), small["means"],
                              np.clip(small["colors"], 0, 255).astype(np.uint8))
        run("colmap", [os.path.join(d, "ws"), "--width", str(w), "--height", str(h),
                       "--steps", str(CLI_STEPS), "--log-every", "5"], d)
    return out


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


def check_viewer(flag_ply, gate_scene, dev):
    """Phase [8]: the render CLI (``scripts/torch_render_cli.py``) in-process
    on the uniform flagship's PLY through its routes, each PNG byte-equal to
    the same frame rendered here and written by the same encoder; the
    interactive viewer's server on port 0 (``/frame``, a key sequence
    through ``/key``, ``/stream``, ``/stats``); then the fps bench at its
    default and at the flagship. Counters are reset just before each CLI
    route and the server session and read just after. Returns (launch
    counts by route, numbers)."""
    import dataclasses
    import threading
    import urllib.request

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig, Splats
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args
    from openglgaussiansplattingrenderer_tpu_torch.splats import inference_config
    from openglgaussiansplattingrenderer_tpu_torch.viewer import interactive, offline

    cli = load_script("torch_render_cli")
    launches, nums = {}, {}
    size = ["--width", str(FLAG_W), "--height", str(FLAG_H)]
    opts = ["--tile-px", "32", "--chunk", "256", "--autotune"]

    def cli_cfg(w, h):
        """The config the CLI makes of ``--tile-px 32`` and its defaults."""
        return RenderConfig.for_resolution(w, h, tile_px=32, chunk=256,
                                           dup_capacity_factor=8.0)

    def ref_pose():
        cam = Camera(5.0, 0.5, -4.0, width=FLAG_W, height=FLAG_H)   # main.cpp:40-44
        cam.set_rotation(-20.0, 40.0, 0.0)
        return cam

    with tempfile.TemporaryDirectory() as d:
        def run(name, argv):
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            launches[name] = read_launches()
            assert rc == 0, f"the render CLI's {name} route exited {rc}"
            log(f"[8] render CLI, {name} route: exit 0 in "
                f"{time.perf_counter() - t0:.2f} s; launches {launches[name]}")

        def same_png(path, image):
            want = os.path.join(d, "want.png")
            save_png(want, image)
            with open(path, "rb") as a, open(want, "rb") as b:
                return a.read() == b.read()

        # the frames the routes must write, rendered here at the same pose
        ref = Splats(flag_ply, FLAG_W, FLAG_H, device=dev, cfg=cli_cfg(FLAG_W, FLAG_H))
        cam = ref_pose()
        ref.autotune_capacity(cam)
        img = ref.render_camera(cam)
        assert float(img[..., 3].max()) > 0.5, "the reference pose sees nothing"

        path = os.path.join(d, "default.png")
        run("default", [flag_ply, "-o", path, *size, *opts, "--stats"])
        assert same_png(path, img), "the default route's PNG is not the frame"

        # q16 implies the packed depth key: its f32 frame is the packed one
        # (phase [3] holds it so too); the 22-bit key's reordering of
        # near-equal depths is logged beside it
        f32_cfg = ref.cfg
        ref.cfg = dataclasses.replace(f32_cfg, depth_key="packed")
        img_packed = ref.render_camera(cam)
        ref.cfg = inference_config(f32_cfg)
        img_q = ref.render_camera(cam)
        ref.cfg = f32_cfg
        path = os.path.join(d, "q16.png")
        run("q16", [flag_ply, "-o", path, *size, *opts, "--q16"])
        assert same_png(path, img_q), "the q16 route's PNG is not the q16 frame"
        q16_err = float(np.abs(img_q - img_packed).max())
        packed_err = float(np.abs(img_packed - img).max())
        assert q16_err <= Q16_FLAG_TOL, f"q16 route: {q16_err} from the packed f32 frame"

        depth, alpha = ref.render_depth_camera(cam)
        covered = alpha > 1e-3
        lo, hi = depth[covered].min(), depth[covered].max()
        depth = np.where(covered, (depth - lo) / max(hi - lo, 1e-12), 0.0)
        path = os.path.join(d, "depth.png")
        run("depth", [flag_ply, "-o", path, *size, *opts, "--depth"])
        assert same_png(path, np.repeat(depth[..., None], 3, axis=-1).astype(np.float32)), (
            "the depth route's PNG is not the depth map")

        orbit_dir = os.path.join(d, "orbit")
        run("orbit", [flag_ply, "--orbit", str(ORBIT_FRAMES), "--out-dir", orbit_dir,
                      "--orbit-radius", "8", *size, *opts])
        cams = offline.orbit_cameras((0.0, 0.0, 0.0), 8.0, ORBIT_FRAMES,
                                     width=FLAG_W, height=FLAG_H)
        for i, c in enumerate(cams):
            frame = offline.render_frame(ref.scene, c, ref.cfg, device=dev)
            assert same_png(os.path.join(orbit_dir, f"frame_{i:04d}.png"),
                            frame[..., :3]), f"orbit frame {i} differs"

        gate_ply = os.path.join(d, "gate.ply")
        ply_io.save_ply(gate_ply, gate_scene["means"], gate_scene["quats"],
                        gate_scene["scales"], gate_scene["opacities"], gate_scene["colors"])
        gate_argv = ["--pos", "0", "0", "-6", "--rot", "0", "0", "0", "--width",
                     str(GATE_W), "--height", str(GATE_H), "--tile-px", "32"]
        path = os.path.join(d, "golden.png")
        run("golden", [gate_ply, "-o", path, "--golden", *gate_argv])
        gs = Splats(gate_ply, GATE_W, GATE_H, device=dev, cfg=cli_cfg(GATE_W, GATE_H))
        gcam = Camera(0.0, 0.0, -6.0, width=GATE_W, height=GATE_H)
        a = camera_args(gcam)
        gold = gs.cpu_render(a["view"], GATE_W, GATE_H, a["focal_x"], a["focal_y"],
                             a["tan_fovx"], a["tan_fovy"], a["vp"], save_path=None)
        assert same_png(path, gold), "the golden route's PNG is not the golden frame"
        gold_vs_card = float(np.abs(gold - gs.render_camera(gcam)).max())
        # the golden sorts on the reference's float key (tile + ndc_z); the
        # oracle on that key is held to it by the golden contract, so the
        # gap to the card's pair-key frame is the key's alone
        oref = Frame(gate_scene, gcam, dataclasses.replace(
            cli_cfg(GATE_W, GATE_H), use_pallas=False, depth_key="reference",
            max_per_tile=2048), dev)
        with torch.no_grad():
            img_ref, st_ref = oref.render()
        assert int(st_ref["dropped_by_cap"]) == 0
        gold_vs_ref = float(np.abs(gold - img_ref.cpu().numpy()).max())
        assert gold_vs_ref <= GOLDEN_TOL, (
            f"golden vs the oracle at depth_key='reference': {gold_vs_ref}")
        log(f"[8] CLI routes: every PNG equal to the frame rendered here; q16 vs the "
            f"packed f32 frame max abs {q16_err:.4e} (limit {Q16_FLAG_TOL}); packed vs "
            f"pair (the default) {packed_err:.4e}; golden 10k frame vs the card's "
            f"kernels {gold_vs_card:.4e}, vs the oracle at depth_key='reference' "
            f"{gold_vs_ref:.4e} (limit {GOLDEN_TOL})")
        nums.update(cli_q16_vs_packed=q16_err, cli_packed_vs_pair=packed_err,
                    golden_vs_card=gold_vs_card, golden_vs_oracle_reference=gold_vs_ref)

    # ---- the interactive viewer's server ----------------------------------
    srv = interactive.make_server(ref, ref_pose(), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                    timeout=300) as r:
            return r.read()

    try:
        reset_launches()
        t0 = time.perf_counter()
        first = get("/frame")
        for k in VIEWER_KEYS:
            get(f"/key?key={k}")
        srv.stream_max_frames = STREAM_FRAMES
        body = get("/stream")          # the queued keys apply at its first frame
        moved = get("/frame")
        stats = json.loads(get("/stats"))
        torch.cuda.synchronize()
        launches["viewer"] = read_launches()
        session_s = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    delivered = body.count(b"--gsframe")
    host = ref_pose()
    for k in VIEWER_KEYS:
        interactive.apply_key(host, k)
    served = srv.state.camera
    assert delivered == STREAM_FRAMES, f"/stream delivered {delivered} of {STREAM_FRAMES}"
    assert np.array_equal(served.position, host.position) and np.array_equal(
        served.rotation, host.rotation), (served.position, host.position)
    assert first == interactive.encode_frame(ref.render_camera(ref_pose()), "PNG"), (
        "/frame is not the frame at the start pose")
    assert moved == interactive.encode_frame(ref.render_camera_u8(host), "PNG"), (
        "/frame after the keys is not render_camera_u8 at the moved pose")
    assert stats["stream_frames"] == STREAM_FRAMES and stats["stream_fps"] > 0, stats
    for k in FRAME_KERNELS:
        assert launches["viewer"][k] > 0, f"{k} kernel never launched by the viewer"

    def render_only():
        ref.render_camera_u8(host, fetch_stats=False)
        torch.cuda.synchronize()

    render_only()
    t0 = time.perf_counter()
    for _ in range(10):
        render_only()
    render_ms = (time.perf_counter() - t0) / 10 * 1e3
    nums.update(viewer_render_only_ms=render_ms, viewer_stream_fps=stats["stream_fps"],
                viewer_encoder=stats["encoder"])
    log(f"[8] viewer: /frame equal to the frame, {len(VIEWER_KEYS)} keys through /key "
        f"moved the camera to pos {host.position.tolist()} rot "
        f"{host.rotation.tolist()} as apply_key does on the host, /frame there equal "
        f"to render_camera_u8; /stream delivered {delivered} frames at "
        f"{stats['stream_fps']} fps (encoder {stats['encoder']}); render-only "
        f"(render_camera_u8 + sync) {render_ms:.3f} ms; session {session_s:.1f} s; "
        f"launches {launches['viewer']}")
    del ref

    bench = load_script("torch_viewer_fps_bench")
    for name, argv in (("default", []), ("flagship", ["--splats", str(FLAG_SPLATS)])):
        t0 = time.perf_counter()
        res = bench.main(argv + ["--frames", str(BENCH_FRAMES)])
        assert res["frames_delivered"] == BENCH_FRAMES, res
        nums[f"fps_bench_{name}"] = res
        log(f"[8] fps bench, {name}: {time.perf_counter() - t0:.1f} s")
    return launches, nums


def check_multi_device(scenes, gate, dev, mesh):
    """Phase [9]: the port's single-controller mesh ``mesh``: MESH_SHARDS
    logical shards on the one card (``make_mesh(devices=["cuda:0"] * 4)``),
    or with ``--cards N`` N cards (``make_mesh(N)``). The fast sharded frame
    against the single-device frame on both flagships, its q16 route, its
    gradients and one ``train_step_fast_sharded``; the oracle
    ``render_sharded`` on the gate scene; a data-parallel step of four
    orbit views against the mean of four single-view gradients, then
    ``fit_scene_dp`` with density control. Counters are reset before each
    route and read after. Returns (launch counts by route, numbers)."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.parallel import data_parallel as dp
    from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
    from openglgaussiansplattingrenderer_tpu_torch.parallel import mesh2d
    from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded as sh
    from openglgaussiansplattingrenderer_tpu_torch.render import (
        autotune_capacity,
        quantize_capacity,
        render_arrays,
    )
    from openglgaussiansplattingrenderer_tpu_torch.splats import inference_config
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
    from openglgaussiansplattingrenderer_tpu_torch.train import losses
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        camera_bundles,
        make_optimizer,
        make_train_step,
        params_from_raw,
        raw_from_params,
    )
    from openglgaussiansplattingrenderer_tpu_torch.viewer.offline import orbit_cameras

    shards = mesh.size
    zero_drop = float(shards)           # an exchange factor that drops no record

    def sync_all():
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
    launches, nums = {}, {}
    fcfg0 = RenderConfig.for_resolution(FLAG_W, FLAG_H, tile_px=32, chunk=256)
    fcam = Camera(0.0, 0.0, -8.0, width=FLAG_W, height=FLAG_H)
    frames = {}
    for name in ("uniform", "clustered"):
        f = Frame(scenes[name], fcam, fcfg0, dev)
        f.cfg = autotune_capacity(f.params, *f.args[:6], FLAG_W, FLAG_H, fcfg0)
        frames[name] = f
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def sharded(f, params, exch, cfg=None):
        return fs.render_fast_sharded(params, *f.args, cfg or f.cfg, mesh, exch_factor=exch)

    # ---- the fast sharded frame against the single-device frame ------------
    with torch.no_grad():
        for name, f in frames.items():
            padded = sh.pad_scene_for_mesh(f.params, shards)
            single, st1 = f.render()
            reset_launches()
            img, st = sharded(f, padded, zero_drop)
            torch.cuda.synchronize()
            if name == "uniform":
                launches["sharded"] = read_launches()
            st = {k: int(v) for k, v in st.items()}
            diff = float((img - single).abs().max())
            assert st["overflow"] == 0, f"{name} sharded: overflow {st['overflow']}"
            assert st["num_records"] == int(st1["num_records"]), (st, int(st1["num_records"]))
            assert diff <= 1e-5, f"{name} sharded frame: max abs {diff} from one device"
            ms_s = cuda_ms(lambda: sharded(f, padded, zero_drop))
            ms_1 = cuda_ms(f.render)
            if name == "uniform":
                for tag, fn, ms in (("sharded", lambda: sharded(f, padded, zero_drop),
                                     ms_s), ("single", f.render, ms_1)):
                    top = device_top(fn)
                    if top is None:
                        log(f"[9] {tag} frame on the device alone: not measured")
                        continue
                    dev_ms, records, names = top
                    nums[f"uniform_{tag}_device"] = dict(
                        device_ms=dev_ms, records=records, busy_share=dev_ms / ms,
                        top=[list(t) for t in names])
                    log(f"[9] uniform {tag} frame on the device alone (profiler, one "
                        f"call, summed over its cards): {dev_ms:.3f} ms in {records} "
                        f"records, {dev_ms / ms:.1%} of its {ms:.3f} ms; the most: " + "; ".join(
                            f"{n} {t:.3f} ms x{c}" for n, t, c in names))
            nums[f"{name}_sharded"] = dict(
                rows=padded["means"].shape[0], max_abs_diff=diff, bit_equal=diff == 0.0,
                sharded_ms=ms_s, single_ms=ms_1, **st,
                cap_exch=fs.exchange_capacity(f.cfg, padded["means"].shape[0] // shards,
                                              shards, zero_drop))
            log(f"[9] {name} flagship padded to {padded['means'].shape[0]} rows, "
                f"{shards} shards, exch_factor {zero_drop}: max abs diff from "
                f"the single-device frame {diff:.3e} (bit-equal {diff == 0.0}); stats "
                f"{st}; sharded frame {ms_s:.3f} ms vs single {ms_1:.3f} ms; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if name == "uniform":
                assert launches["sharded"]["composite"] == shards, launches["sharded"]
                # one splat table a shard, as one a frame on one device
                assert launches["sharded"]["splat_table"] == shards, launches["sharded"]
                for k in FRAME_KERNELS:
                    assert launches["sharded"][k] > 0, f"{k} never launched by the sharded frame"
                img2, st2 = sharded(f, padded, 2.0)
                with warnings.catch_warnings(record=True) as wl:
                    warnings.simplefilter("always")
                    ov = fs.warn_on_sharded_overflow(st2, 2.0, shards)
                fired = any("dropped" in str(w.message) for w in wl)
                assert fired == (ov > 0), (ov, fired)
                diff2 = float((img2 - single).abs().max())
                if ov == 0:
                    assert diff2 <= 1e-5, diff2
                nums["uniform_exch2"] = dict(overflow=ov, warned=fired, max_abs_diff=diff2)
                log(f"[9] uniform, exch_factor 2.0 (default): overflow {ov}, warning "
                    f"fired {fired}, max abs diff {diff2:.3e}")
                # q16 through the exchange. Its merge sorts the 22-bit packed
                # key, the f32 merge the exact pair: its f32 frame is the
                # packed one of one device (as in phase [3])
                cfg_q = inference_config(f.cfg)
                img_q, _ = sharded(f, padded, zero_drop, cfg_q)
                packed1, _ = f.with_cfg(dataclasses.replace(f.cfg, depth_key="packed")).render()
                q1, _ = f.with_cfg(cfg_q).render()
                q_err = float((img_q - packed1).abs().max())
                q_single = float((img_q - q1).abs().max())
                q_pair = float((img_q - img).abs().max())
                assert q_err <= Q16_FLAG_TOL, f"sharded q16: {q_err} from the packed f32 frame"
                assert q_single <= Q16_FLAG_TOL, f"sharded q16: {q_single} from one device's"
                del img2, img_q, packed1, q1
            del img, single, padded

    # q16's backward raises
    f = frames["uniform"]
    p = {k: v.detach().requires_grad_(True)
         for k, v in sh.pad_scene_for_mesh(f.params, shards).items()}
    img_q, _ = sharded(f, p, zero_drop, inference_config(f.cfg))
    try:
        torch.autograd.grad(img_q[..., :3].mean(), list(p.values()))
        raise AssertionError("the sharded q16 backward did not raise")
    except NotImplementedError as e:
        assert "inference-only" in str(e)
    del img_q, p
    nums["uniform_q16"] = dict(vs_packed_f32=q_err, vs_single_q16=q_single,
                               vs_sharded_f32=q_pair, backward_raises=True)
    log(f"[9] sharded q16 frame vs one device's packed f32 frame: max abs {q_err:.4e} "
        f"(limit {Q16_FLAG_TOL}); vs one device's q16 frame {q_single:.4e}; vs the "
        f"sharded f32 (exact pair key) frame {q_pair:.4e}; its backward raises "
        "NotImplementedError")

    # ---- gradients of the gs loss, sharded vs one device --------------------
    with torch.no_grad():
        target = f.render()[0][..., :3].contiguous()
    colors = f.params["colors"].cpu().numpy()
    noisy = np.clip(colors + np.random.default_rng(0).normal(0, 40, colors.shape),
                    5, 250).astype(np.float32)
    start = dict(f.params, colors=torch.as_tensor(noisy).to(dev))
    n = start["means"].shape[0]
    raw = raw_from_params(sh.pad_scene_for_mesh(start, shards))

    def grads(render):
        leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
        loss = losses.gs_loss(render(params_from_raw(leaves))[..., :3], target, 0.2)
        return float(loss.detach()), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_s, g_s = grads(lambda p: sharded(f, p, zero_drop)[0])
    torch.cuda.synchronize()
    fb_s = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loss_1, g_1 = grads(lambda p: render_arrays({k: v[:n] for k, v in p.items()},
                                                *f.args, f.cfg)[0])
    torch.cuda.synchronize()
    fb_1 = (time.perf_counter() - t0) * 1e3
    share = {}
    for k, g in g_1.items():
        scale = float(g[:n].abs().max())
        share[k] = float((g_s[k][:n] - g[:n]).abs().max()) / max(scale, 1e-30)
    del g_s, g_1
    assert max(share.values()) <= GRAD_REL_TOL, f"sharded gradients: {share}"
    optimizer = make_optimizer(TrainConfig(lambda_dssim=0.2))
    raw_shards = sh.shard_params(raw, mesh)
    reset_launches()
    sync_all()
    t0 = time.perf_counter()
    new_raw, _, loss_step, st = fs.train_step_fast_sharded(
        raw_shards, [optimizer.init(s) for s in raw_shards], target, *f.args[:6], width=FLAG_W,
        height=FLAG_H, cfg=f.cfg, mesh=mesh, optimizer=optimizer,
        exch_factor=zero_drop, lambda_dssim=0.2)
    sync_all()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches["sharded_train"] = read_launches()
    assert int(st["overflow"]) == 0 and abs(float(loss_step) - loss_s) <= 1e-6
    for k, v in sh.gather_shards(new_raw, dev).items():
        assert bool(torch.isfinite(v).all()), f"sharded train step: non-finite {k}"
    for k in STEP_KERNELS:
        assert launches["sharded_train"][k] > 0, f"{k} never launched by the sharded step"
    del new_raw, raw_shards
    nums["sharded_grads"] = dict(loss_sharded=loss_s, loss_single=loss_1,
                                 worst_share=share, fwd_bwd_sharded_ms=fb_s,
                                 fwd_bwd_single_ms=fb_1, train_step_ms=step_ms,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[9] gs loss (lambda 0.2) gradients, sharded vs one device, max abs / max |g|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in share.items())
        + f" (limit {GRAD_REL_TOL}); loss {loss_s:.6f} vs {loss_1:.6f}; forward + "
        f"backward {fb_s:.1f} ms sharded, {fb_1:.1f} ms single (host clock, first "
        f"call); train_step_fast_sharded {step_ms:.1f} ms; launches "
        f"{launches['sharded_train']}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- the oracle on the gate scene ---------------------------------------
    ocfg = dataclasses.replace(gate.cfg, use_pallas=False, max_per_tile=2048)
    with torch.no_grad():
        reset_launches()
        img_o = sh.render_sharded(gate.params, *gate.args, ocfg, mesh)
        torch.cuda.synchronize()
        launches["oracle_sharded"] = read_launches()
        img_g, st_g = fs.render_fast_sharded(gate.params, *gate.args, gate.cfg, mesh,
                                             exch_factor=zero_drop)
    assert not any(launches["oracle_sharded"].values()), launches["oracle_sharded"]
    assert int(st_g["overflow"]) == 0
    err, bad = image_diff(img_o, img_g)
    assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
        f"sharded oracle vs fast sharded gate frame: {err} on {bad} px")
    nums["oracle_gate"] = dict(max_abs=err, px_above_1e3=bad)
    log(f"[9] render_sharded (oracle) on the gate scene vs the fast sharded frame: "
        f"max abs {err:.3e}, {bad} px > 1e-3 (limits {GATE_MAX_ABS}, {GATE_MAX_PX}); "
        f"no kernel launched")
    del img_o, img_g

    # ---- data-parallel: four orbit views of the flagship ---------------------
    cams = orbit_cameras((0.0, 0.0, 0.0), 8.0, DP_BATCH, width=FLAG_W, height=FLAG_H)
    bundles = camera_bundles(cams, dev)
    cap = max(autotune_capacity(f.params, *b, FLAG_W, FLAG_H, fcfg0).capacity_records
              for b in bundles)
    dcfg = dataclasses.replace(fcfg0, capacity_records=cap)
    with torch.no_grad():
        targets = [render_arrays(f.params, *b, FLAG_W, FLAG_H, dcfg)[0][..., :3].contiguous()
                   for b in bundles]
    tc = TrainConfig(lambda_dssim=0.2)
    raw = raw_from_params(start)
    keys = tuple(sorted(raw))
    step = dp.make_dp_train_step(dcfg, tc, FLAG_W, FLAG_H, mesh, batch=DP_BATCH,
                                 param_keys=keys)
    reps = dp.replicate_tree(raw, mesh)
    args = dp.stack_view_batch(targets, bundles, dev)
    opt0 = step.init(reps)
    sync_all()
    t0 = time.perf_counter()
    new_raw, new_opt, loss_dp, _ = step(reps, opt0, *args)
    sync_all()
    dp_first_ms = (time.perf_counter() - t0) * 1e3
    wall = []
    for _ in range(3):      # the same step again, past each card's first launches
        t0 = time.perf_counter()
        step(reps, opt0, *args)
        sync_all()
        wall.append((time.perf_counter() - t0) * 1e3)
    dp_ms = statistics.median(wall)
    mean_g = {k: torch.zeros_like(v) for k, v in raw.items()}
    for t, b in zip(targets, bundles):
        leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
        img, _ = render_arrays(params_from_raw(leaves), *b, FLAG_W, FLAG_H, dcfg)
        loss = losses.gs_loss(img[..., :3], t, tc.lambda_dssim)
        for k, g in zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])):
            mean_g[k] += g / DP_BATCH
    # Adam's first moment after one step is (1 - b1) times the gradient it used
    dp_share = {k: float((new_opt[0]["mu"][k] / 0.1 - g).abs().max())
                / max(float(g.abs().max()), 1e-30) for k, g in mean_g.items()}
    assert max(dp_share.values()) <= GRAD_REL_TOL, f"dp step gradient: {dp_share}"
    for r in new_raw[1:]:
        assert all(torch.equal(r[k].to(dev), new_raw[0][k].to(dev)) for k in keys), (
            "replicas differ")
    del new_raw, new_opt, mean_g, reps
    nums["dp_step"] = dict(ms=dp_ms, first_ms=dp_first_ms, loss=float(loss_dp),
                           worst_share=dp_share,
                           capacity=cap,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[9] make_dp_train_step, batch {DP_BATCH} orbit views on {shards} shards "
        f"(capacity {cap}): {dp_ms:.1f} ms (host clock, median of 3; the first "
        f"call {dp_first_ms:.1f} ms); its gradient "
        f"(Adam's mu / 0.1) vs the mean of four single-view gradients, max abs / max "
        "|g|: " + ", ".join(f"{k} {v:.3e}" for k, v in dp_share.items())
        + f" (limit {GRAD_REL_TOL})")

    # fit_scene_dp with density control: DP_STEPS steps, one densify
    means = start["means"].cpu().numpy()
    dc = dn.DensifyConfig(capacity=DENSIFY_CAPACITY, grad_threshold=DP_DENSIFY_THRESHOLD,
                          percent_dense=DENSIFY_PERCENT,
                          scene_extent=float(np.abs(means - means.mean(axis=0)).max()),
                          start_step=DP_DENSIFY_AT, interval=DP_DENSIFY_AT,
                          stop_step=DP_DENSIFY_AT + 1)
    reset_launches()
    sync_all()
    t0 = time.perf_counter()
    _, alive, hist = dp.fit_scene_dp(
        start, targets, cams, dcfg, TrainConfig(steps=DP_STEPS, lambda_dssim=0.2),
        mesh=mesh, batch=DP_BATCH, dc=dc, log_every=1, verbose=False)
    sync_all()
    fit_s = time.perf_counter() - t0
    launches["dp"] = read_launches()
    assert all(np.isfinite(h["loss"]) for h in hist), hist
    assert int(alive.sum()) == hist[-1]["alive"]
    for k in STEP_KERNELS:
        assert launches["dp"][k] > 0, f"{k} never launched by fit_scene_dp"
    nums["fit_scene_dp"] = dict(seconds=fit_s, losses=[h["loss"] for h in hist],
                                alive=[h["alive"] for h in hist],
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[9] fit_scene_dp, {DP_STEPS} steps of batch {DP_BATCH}, densify at step "
        f"{DP_DENSIFY_AT} (capacity {DENSIFY_CAPACITY}): {fit_s:.1f} s; loss "
        + " ".join(f"{h['loss']:.5f}" for h in hist) + "; alive "
        + " ".join(str(h["alive"]) for h in hist) + f"; launches {launches['dp']}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- the 2-D (view x splat) mesh: two orbit views, two splat shards -----
    m2 = mesh2d.make_mesh2d(M2_DV, M2_DS, devices=list(mesh.devices[:M2_DV * M2_DS]))
    cams2, bundles2, targets2 = cams[:M2_DV], bundles[:M2_DV], targets[:M2_DV]
    raw2 = raw_from_params(sh.pad_scene_for_mesh(start, M2_DS))
    keys2 = tuple(sorted(raw2))
    step2 = mesh2d.make_2d_train_step(dcfg, tc, FLAG_W, FLAG_H, m2, batch=M2_DV,
                                      param_keys=keys2, exch_factor=float(M2_DS),
                                      with_grad_norms=True)
    args2 = (torch.stack([torch.from_numpy(mesh2d.tile_target(t, FLAG_W, FLAG_H, dcfg)[0])
                          for t in targets2]).to(dev),
             torch.stack([b[0] for b in bundles2]), torch.stack([b[1] for b in bundles2]),
             *(torch.tensor([float(b[j]) for b in bundles2]) for j in (2, 3, 4, 5)))
    rs2 = mesh2d.shard_raw_2d(raw2, m2)
    opt2 = step2.init(rs2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync_all()
    t0 = time.perf_counter()
    _, new_opt2, loss2d, psnr2d, over2d, gnorm2d, seen2d = step2(rs2, opt2, *args2)
    sync_all()
    m2_first_ms = (time.perf_counter() - t0) * 1e3
    launches["mesh2d"] = read_launches()
    m2_peak = torch.cuda.max_memory_allocated() / 2**30
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = step2(rs2, opt2, *args2)
        sync_all()
        wall.append((time.perf_counter() - t0) * 1e3)
    # the same step on the same inputs: bit for bit on one card; across
    # cards autograd adds what reaches a tensor from other cards in the
    # order it arrives
    mu_first, mu_again = (mesh2d._gather_state_2d(o, dev)["mu"] for o in (new_opt2, again[1]))
    repeat_apart = {k: float((mu_again[k] - mu_first[k]).abs().max()) for k in mu_first}
    del again, mu_first, mu_again
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        ov2 = fs.warn_on_sharded_overflow({"overflow": over2d}, float(M2_DS), M2_DS)
    assert ov2 == 0 and not wl, f"2-D step: overflow {ov2} at exch_factor {M2_DS}"
    for k in STEP_KERNELS:
        assert launches["mesh2d"][k] > 0, f"{k} never launched by the 2-D step"
    # against two single-view make_train_step steps: Adam's first moment
    # after one step is (1 - b1) times the gradient it used
    single = make_train_step(dcfg, tc, FLAG_W, FLAG_H, with_grad_norms=True,
                             param_keys=keys2)
    g_ref = {k: torch.zeros_like(v) for k, v in raw2.items()}
    loss_ref, stat_ref, seen_ref = 0.0, None, None
    for t, b in zip(targets2, bundles2):
        st1, met = single(single.init(raw2), t, *b)
        for k in keys2:
            g_ref[k] += st1.opt_state["mu"][k] / 0.1 / M2_DV
        loss_ref += float(met["loss"]) / M2_DV
        stat = met["densify_grad_norm"]
        stat_ref = stat if stat_ref is None else stat_ref + stat
        hit = (stat > 0).float()
        seen_ref = hit if seen_ref is None else seen_ref + hit
        del st1
    mu2 = mesh2d._gather_state_2d(new_opt2, dev)["mu"]
    m2_share = {k: float((mu2[k] / 0.1 - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for k, g in g_ref.items()}
    stat_share = float((gnorm2d - stat_ref).abs().max()) / max(float(stat_ref.max()), 1e-30)
    loss_share = abs(float(loss2d) - loss_ref) / loss_ref
    assert max(m2_share.values()) <= GRAD_REL_TOL, f"2-D step gradient: {m2_share}"
    assert loss_share <= GRAD_REL_TOL, f"2-D loss {float(loss2d)} vs {loss_ref}"
    assert stat_share <= GRAD_REL_TOL, f"2-D densify statistic: {stat_share}"
    assert torch.equal(seen2d, seen_ref), "2-D seen counts differ from the views'"
    del g_ref, mu2, new_opt2, rs2, opt2, stat_ref, seen_ref
    nums["mesh2d_step"] = dict(
        mesh=f"{M2_DV}x{M2_DS}", devices=[str(d) for d in m2.devices[0] + m2.devices[1]],
        rows=raw2["means"].shape[0], ms=statistics.median(wall), first_ms=m2_first_ms,
        peak_gib=m2_peak, loss=float(loss2d), loss_ref=loss_ref, psnr=float(psnr2d),
        overflow=ov2, worst_share=m2_share, stat_share=stat_share,
        repeat_mu_apart=repeat_apart)
    log(f"[9] 2-D step on {m2!r}, {M2_DV} orbit views, {raw2['means'].shape[0]} rows, "
        f"exch_factor {M2_DS}: {statistics.median(wall):.1f} ms (host clock, median of 3; "
        f"first call {m2_first_ms:.1f} ms); peak {m2_peak:.2f} GiB; overflow 0, no "
        f"warning; loss {float(loss2d):.6f} vs the views' mean {loss_ref:.6f}; gradient "
        "(Adam's mu / 0.1) vs the mean of two make_train_step gradients, max abs / max "
        "|g|: " + ", ".join(f"{k} {v:.3e}" for k, v in m2_share.items())
        + f"; densify statistic vs the sum of the views' {stat_share:.3e} (limit "
        f"{GRAD_REL_TOL}); the step again on the same inputs, Adam's first moment apart "
        f"by {repeat_apart}; launches {launches['mesh2d']}")

    # fit_scene_2d with one densify, against the same fit on a (1, 1) mesh.
    # capacity_records bounds each splat shard's records, so the one shard
    # of the 1x1 mesh has half the room of two: the fits take headroom for
    # the records the densify adds, and neither may drop one. Two shards
    # sum in another order than one (and across cards autograd adds what
    # arrives from other cards in arrival order), and Adam normalises every
    # element, so an element whose gradient nearly cancels moves by its
    # rounding's share of a step: the steps before the densify are held by
    # Adam's first moment, linear in the gradients, at GRAD_REL_TOL of each
    # tensor's largest (the parameters' elements outside rtol 2e-4 / atol
    # 1e-6 are counted). Density control's decisions are discontinuous: the
    # fits densify every splat the views' gradients reach (threshold 0), a
    # set no rounding changes, and hold the alive masks equal and the
    # losses within GRAD_REL_TOL; the rank order of near-equal candidates,
    # which decides their slots and split draws, is counted, not held
    fcfg = dataclasses.replace(dcfg, capacity_records=quantize_capacity(
        dcfg.capacity_records, M2_FIT_HEADROOM))
    dc_fit = dataclasses.replace(dc, grad_threshold=0.0)
    x0, _ = dn.pad_to_capacity(raw_from_params(start), dc_fit.capacity)
    steps_before, m11 = {}, mesh2d.make_mesh2d(1, 1, devices=[dev])
    for name, mm in (("2d", m2), ("1x1", m11)):
        stp = mesh2d.make_2d_train_step(fcfg, tc, FLAG_W, FLAG_H, mm, batch=M2_DV,
                                        param_keys=keys2, with_grad_norms=True)
        rs = mesh2d.shard_raw_2d(x0, mm)
        st = stp.init(rs)
        for _ in range(DP_DENSIFY_AT):
            rs, st, *_ = stp(rs, st, *args2)
        steps_before[name] = (mesh2d.gather_raw_2d(rs, dev),
                              mesh2d._gather_state_2d(st, dev)["mu"])
        del rs, st
    (b2, mu_2), (b1, mu_1) = steps_before["2d"], steps_before["1x1"]
    mu_share = {k: float((mu_2[k] - mu_1[k]).abs().max()) / max(float(mu_1[k].abs().max()),
                                                                1e-30) for k in mu_1}
    off = {k: int((~torch.isclose(b2[k], b1[k], rtol=2e-4, atol=1e-6)).sum()) for k in b1}
    assert max(mu_share.values()) <= GRAD_REL_TOL, (
        f"2-D steps vs 1x1 steps, Adam's first moment: {mu_share}")
    del steps_before, b2, b1, mu_2, mu_1, x0, args2
    fits = {}
    for name, mm in (("2d", m2), ("1x1", m11)):
        if name == "2d":
            reset_launches()
        sync_all()
        t0 = time.perf_counter()
        fits[name] = mesh2d.fit_scene_2d(
            start, targets2, cams2, fcfg, TrainConfig(steps=DP_STEPS, lambda_dssim=0.2),
            mesh=mm, batch=M2_DV, dc=dc_fit, log_every=1, verbose=False)
        sync_all()
        fits[name] += (time.perf_counter() - t0,)
        if name == "2d":
            launches["mesh2d_fit"] = read_launches()
    (p2, alive2, hist2, s2), (p1, alive1, hist1, s1) = fits["2d"], fits["1x1"]
    assert all(np.isfinite(h["loss"]) for h in hist2 + hist1), (hist2, hist1)
    assert int(alive2.sum()) == hist2[-1]["alive"]
    assert all(h["overflow"] == 0 for h in hist2 + hist1), (hist2, hist1)
    for k in STEP_KERNELS:
        assert launches["mesh2d_fit"][k] > 0, f"{k} never launched by fit_scene_2d"
    assert torch.equal(alive2, alive1), "2-D fit: alive mask differs from the 1x1 fit's"
    loss_apart = max(abs(h2["loss"] - h1["loss"]) / h1["loss"] for h2, h1 in zip(hist2, hist1))
    assert loss_apart <= GRAD_REL_TOL, f"2-D fit loss vs 1x1: {hist2} {hist1}"
    n_new = int(alive2.sum()) - start["means"].shape[0]
    apart_end = int((~torch.stack([torch.isclose(p2[k], p1[k], rtol=2e-4, atol=1e-6).reshape(
        p1[k].shape[0], -1).all(dim=1) for k in p1]).all(dim=0)).sum())
    del fits, p2, p1
    nums["fit_scene_2d"] = dict(
        seconds=s2, seconds_1x1=s1, losses=[h["loss"] for h in hist2],
        losses_1x1=[h["loss"] for h in hist1], alive=[h["alive"] for h in hist2],
        mu_share_before_densify=mu_share, elements_outside_rtol_before_densify=off,
        loss_apart=loss_apart, rows_added=n_new, rows_apart_at_end=apart_end,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[9] fit_scene_2d, {DP_STEPS} steps of batch {M2_DV} on {M2_DV}x{M2_DS}, one "
        f"densify at step {DP_DENSIFY_AT} of every splat with a gradient: {s2:.1f} s (1x1: "
        f"{s1:.1f} s); loss " + " ".join(f"{h['loss']:.5f}" for h in hist2) + "; alive "
        + " ".join(str(h["alive"]) for h in hist2) + f"; vs 1x1: Adam's first moment after "
        f"{DP_DENSIFY_AT} steps, of each tensor's largest: " + ", ".join(
            f"{k} {v:.3e}" for k, v in mu_share.items()) + f" (limit {GRAD_REL_TOL}; the "
        f"parameters' elements outside rtol 2e-4 / atol 1e-6: {off}); the fits' alive masks "
        f"equal, losses within {loss_apart:.3e} relative (limit {GRAD_REL_TOL}); rows apart "
        f"after the last step {apart_end} ({n_new} rows added); launches "
        f"{launches['mesh2d_fit']}")

    # ---- the process-group backend: the same frame and step across ranks ----
    del raw2, targets, bundles
    pg_launches, nums["process_group"] = check_process_group(f, start, target, dev,
                                                             len(set(mesh.devices)))
    launches.update(pg_launches)
    return launches, nums


def check_process_group(f, start, target, dev, cards):
    """Phase [9], the process-group backend (``parallel/multihost.py``): the
    uniform flagship (colours perturbed as in the gradient check) split
    over ranks launched by ``multihost.spawn``, each rank a process
    holding only its rows: on one card two gloo ranks on ``cuda:0`` (NCCL
    refuses two ranks on one device; gloo stages through the host), over
    N cards N NCCL ranks, one card each. The frame must be bit-equal to
    the single-controller frame of as many shards, the gs-loss gradients
    of each rank's rows within ``GRAD_REL_TOL`` of the controller's, and
    one ``train_step_fast_sharded`` must give the gradient run's loss.
    Returns (launches summed over ranks: the frame, the step; numbers)."""
    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
    from openglgaussiansplattingrenderer_tpu_torch.parallel import multihost
    from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded as sh
    from openglgaussiansplattingrenderer_tpu_torch.train import losses
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        params_from_raw,
        raw_from_params,
    )

    world = cards if cards > 1 else PG_RANKS_ONE_CARD
    backend = "nccl" if cards > 1 else "gloo"
    padded = sh.pad_scene_for_mesh(start, world)
    rows = padded["means"].shape[0]
    mesh = sh.make_mesh(world) if cards > 1 else sh.make_mesh(devices=[dev] * world)
    exch = float(world)
    with torch.no_grad():
        ref_img, ref_st = fs.render_fast_sharded(padded, *f.args, f.cfg, mesh, exch_factor=exch)
        ref_img = ref_img.cpu()
    assert int(ref_st["overflow"]) == 0
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw_from_params(padded).items()}
    img, _ = fs.render_fast_sharded(params_from_raw(leaves), *f.args, f.cfg, mesh,
                                    exch_factor=exch)
    loss = losses.gs_loss(img[..., :3], target, 0.2)
    ref_g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref_loss = float(loss.detach())
    del img, loss, leaves
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        for k, v in padded.items():
            np.save(os.path.join(tmp, f"p_{k}.npy"), v.cpu().numpy())
        np.save(os.path.join(tmp, "target.npy"), target.cpu().numpy())
        for name, m in zip(("view", "vp"), f.args[:2]):
            np.save(os.path.join(tmp, f"{name}.npy"), m.cpu().numpy())
        # the ranks need the card's index: torch.device("cuda") has none
        one_card = (torch.device("cuda", torch.cuda.current_device())
                    if dev.type == "cuda" and dev.index is None else dev)
        spec = dict(backend=backend, device=None if cards > 1 else str(one_card), rows=rows,
                    capacity=f.cfg.capacity_records, exch=exch,
                    cam=[float(x) for x in f.args[2:6]], keys=sorted(padded))
        with open(os.path.join(tmp, "spec.json"), "w") as fh:
            json.dump(spec, fh)
        t0 = time.perf_counter()
        results = multihost.spawn([sys.executable, os.path.abspath(__file__), "--pg-worker",
                                   tmp], world, timeout_s=PG_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        for rank, (rc, out) in enumerate(results):
            for line in out.strip().splitlines()[-6:]:
                log(f"[9] pg rank {rank}: {line}")
            assert rc == 0, f"process-group rank {rank} exited {rc}"
        reports = []
        for rank in range(world):
            with open(os.path.join(tmp, f"report{rank}.json")) as fh:
                reports.append(json.load(fh))
        pg_img = torch.from_numpy(np.load(os.path.join(tmp, "img.npy")))
        diff = float((pg_img - ref_img).abs().max())
        assert torch.equal(pg_img, ref_img), (
            f"{world} {backend} ranks: frame {diff} from the single-controller frame")
        m = rows // world
        share = {k: 0.0 for k in ref_g}
        for rank in range(world):
            got = np.load(os.path.join(tmp, f"grads{rank}.npz"))
            for k, g in ref_g.items():
                want = g[rank * m:(rank + 1) * m].cpu().numpy()
                scale = max(float(g.abs().max()), 1e-30)
                share[k] = max(share[k], float(np.abs(got[k] - want).max()) / scale)
    assert max(share.values()) <= GRAD_REL_TOL, f"process-group gradients: {share}"
    for r in reports:
        assert abs(r["loss"] - ref_loss) <= 1e-6 * max(ref_loss, 1.0), (r["loss"], ref_loss)
        assert r["step_loss"] == r["loss"] and r["overflow"] == 0, r
    launches = {"pg_frame": {k: sum(r["frame_launches"][k] for r in reports)
                             for k in reports[0]["frame_launches"]},
                "pg_step": {k: sum(r["step_launches"][k] for r in reports)
                            for k in reports[0]["step_launches"]}}
    for k in FRAME_KERNELS:
        assert launches["pg_frame"][k] > 0, f"{k} never launched by the process-group frame"
    for k in STEP_KERNELS:
        assert launches["pg_step"][k] > 0, f"{k} never launched by the process-group step"
    nums = dict(ranks=world, backend=backend, rows=rows, bit_equal=True, worst_share=share,
                spawn_wall_s=wall_s,
                per_rank=[{k: r[k] for k in ("device", "frame_ms", "staging_frame_s",
                                             "step_ms", "staging_step_s", "peak_gib")}
                          for r in reports])
    log(f"[9] process group, {world} {backend} ranks ({', '.join(r['device'] for r in reports)}"
        f"): frame bit-equal to the single-controller {world}-shard frame; frame ms by "
        "rank " + "; ".join(f"{r['frame_ms']}" for r in reports) + " (host clock, 3 "
        "runs); host staging of one frame's collectives " + ", ".join(
            f"{r['staging_frame_s'] * 1e3:.1f}" for r in reports) + " ms; gradients vs "
        "the controller's, max abs / max |g|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in share.items()) + f" (limit {GRAD_REL_TOL}); step "
        "ms by rank " + ", ".join(f"{r['step_ms']:.1f}" for r in reports) + "; launches "
        f"{launches}; the ranks took {wall_s:.1f} s from spawn to exit")
    return launches, nums


def pg_worker(tmp):
    """One rank of ``check_process_group`` (``chip_smoke.py --pg-worker
    DIR``, with torchrun's environment from ``multihost.spawn``): joins
    the group, loads its rows of the scene the launcher saved, renders the
    frame (counts reset before, read after; then three timed frames),
    takes the gs-loss gradients of its rows, runs one
    ``train_step_fast_sharded``, and writes its report (rank 0 also the
    frame)."""
    import dataclasses

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
    from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
    from openglgaussiansplattingrenderer_tpu_torch.parallel import multihost
    from openglgaussiansplattingrenderer_tpu_torch.train import losses
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizer,
        params_from_raw,
        raw_from_params,
    )

    with open(os.path.join(tmp, "spec.json")) as fh:
        spec = json.load(fh)
    # the rank's card is current before it joins: NCCL binds to it
    device = torch.device(spec["device"] or f"cuda:{multihost.local_rank()}")
    torch.cuda.set_device(device)
    multihost.initialize(backend=spec["backend"], timeout_s=PG_INIT_TIMEOUT_S)
    rank, world = multihost.process_index(), multihost.process_count()
    build.load_library()
    mesh = multihost.global_mesh(device)
    m = spec["rows"] // world
    local = [{k: torch.from_numpy(np.load(os.path.join(tmp, f"p_{k}.npy"), mmap_mode="r")
                                  [rank * m:(rank + 1) * m].copy()).to(device)
              for k in spec["keys"]}]
    cfg = dataclasses.replace(RenderConfig.for_resolution(FLAG_W, FLAG_H, tile_px=32,
                                                          chunk=256),
                              capacity_records=spec["capacity"])
    args = (*(torch.from_numpy(np.load(os.path.join(tmp, f"{n}.npy"))).to(device)
              for n in ("view", "vp")), *spec["cam"])
    target = torch.from_numpy(np.load(os.path.join(tmp, "target.npy"))).to(device)

    def frame(params):
        return fs.render_fast_sharded(params, *args, FLAG_W, FLAG_H, cfg, mesh,
                                      exch_factor=spec["exch"])

    def synced_ms(fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        frame(local)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        mesh.staging_s = 0.0
        (img, st), _ = synced_ms(lambda: frame(local))
        frame_launches, staging_frame = read_launches(), mesh.staging_s
        frame_ms = [round(synced_ms(lambda: frame(local))[1], 3) for _ in range(3)]
    raw = {k: v.detach().requires_grad_(True) for k, v in raw_from_params(local[0]).items()}
    img_g, _ = frame([params_from_raw(raw)])
    loss = losses.gs_loss(img_g[..., :3], target, 0.2)
    grads = torch.autograd.grad(loss, list(raw.values()))
    np.savez(os.path.join(tmp, f"grads{rank}.npz"),
             **{k: g.cpu().numpy() for k, g in zip(raw, grads)})
    del img_g, grads
    optimizer = make_optimizer(TrainConfig(lambda_dssim=0.2))
    raw0 = [raw_from_params(local[0])]
    reset_launches()
    mesh.staging_s = 0.0
    (new_raw, _, step_loss, st2), step_ms = synced_ms(lambda: fs.train_step_fast_sharded(
        raw0, [optimizer.init(raw0[0])], target, *args, width=FLAG_W, height=FLAG_H, cfg=cfg,
        mesh=mesh, optimizer=optimizer, exch_factor=spec["exch"]))
    step_launches, staging_step = read_launches(), mesh.staging_s
    assert all(bool(torch.isfinite(v).all()) for v in new_raw[0].values())
    report = dict(rank=rank, device=str(device), backend=mesh.backend, frame_ms=frame_ms,
                  staging_frame_s=staging_frame, step_ms=step_ms, staging_step_s=staging_step,
                  frame_launches=frame_launches, step_launches=step_launches,
                  loss=float(loss.detach()), step_loss=float(step_loss),
                  overflow=int(st["overflow"]) + int(st2["overflow"]),
                  peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    if rank == 0:
        np.save(os.path.join(tmp, "img.npy"), img.cpu().numpy())
    with open(os.path.join(tmp, f"report{rank}.json"), "w") as fh:
        json.dump(report, fh)
    print(f"rank {rank} on {device} ({mesh.backend}): frame {frame_ms} ms, step "
          f"{step_ms:.1f} ms", flush=True)
    multihost.shutdown()


def check_parallel_cli(dev, cards):
    """Phase [9], the training CLI's parallel routes in-process on a
    2,000-splat scene at 256x256 (4 views, 4 steps, ``--densify``): on one
    card ``--mesh2d 1x1`` and ``--data-parallel 1``, over four cards
    ``--mesh2d 2x2`` and ``--data-parallel 4``. Each must exit 0 and write
    its PLY, PNG and history with a finite PSNR. Returns numbers by route."""
    import numpy as np

    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    cli = load_script("torch_train_cli")
    routes = ((["--mesh2d", "2x2"], ["--data-parallel", "4"]) if cards >= 4
              else (["--mesh2d", "1x1"], ["--data-parallel", "1"]))
    nums = {}
    with tempfile.TemporaryDirectory() as d:
        sc = ply_io.make_synthetic_scene(2000, seed=5, extent=1.5)
        scene = os.path.join(d, "scene.ply")
        ply_io.save_ply(scene, sc["means"], sc["quats"], sc["scales"], sc["opacities"],
                        sc["colors"])
        for flag in routes:
            tag = "".join(flag).replace("--", "")
            outs = [os.path.join(d, f"{tag}.{e}") for e in ("ply", "png", "json")]
            t0 = time.perf_counter()
            rc = cli.main([scene, "-o", outs[0], "--out-png", outs[1], "--history", outs[2],
                           "--width", "256", "--height", "256", "--views", "4",
                           "--steps", "4", "--densify", "--densify-start", "1",
                           "--densify-interval", "2", "--log-every", "1", *flag])
            secs = time.perf_counter() - t0
            assert rc == 0, f"training CLI {' '.join(flag)} exited {rc}"
            assert all(os.path.exists(o) for o in outs), outs
            with open(outs[2]) as fh:
                hist = json.load(fh)
            assert np.isfinite(hist["final_psnr_view0"]), hist
            nums[" ".join(flag)] = dict(seconds=secs, psnr=hist["final_psnr_view0"],
                                        splats=hist["splats"])
    log("[9] training CLI, parallel routes: " + "; ".join(
        f"{k}: exit 0, {v['splats']} splats, view-0 PSNR {v['psnr']:.2f} dB, "
        f"{v['seconds']:.1f} s" for k, v in nums.items()))
    return nums


def check_dryrun_and_scaling(cards):
    """Phase [9], last: ``dryrun_multichip(8)`` on the card(s), and the
    scaling report (``scripts/torch_scaling_report.py``) with its flagship
    table. Returns their numbers."""
    from openglgaussiansplattingrenderer_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(DRYRUN_SHARDS)
    dry["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):      # its JSON line: kept below
        rep = load_script("torch_scaling_report").main(["--json"])
    rep["seconds"] = time.perf_counter() - t0
    log(f"[9] dryrun_multichip({DRYRUN_SHARDS}) on {sorted(set(dry['devices']))}: ok in "
        f"{dry['seconds']:.1f} s; scaling report in {rep['seconds']:.1f} s, link "
        f"{rep['link']['gbps']:.1f} GB/s ({rep['link']['source']}); cross-check "
        f"{rep['scene']['cross_check']}")
    for r in rep["flagship"]["table"]:
        log(f"[9] scaling, flagship on {r['devices']} shards: max owner records "
            f"{r['max_owner_records']}, pair work max/mean {r['pairs_imbalance']:.3f}, "
            f"efficiency bound {r['efficiency_bound']:.1%}, exchange "
            f"{r['exchange_bytes'] / 1e6:.1f} MB in {r['exchange_ms']:.3f} ms, bound "
            f"{r['bound_frame_ms']} ms ({r['bound_fps']} fps), measured "
            f"{r['measured_frame_ms']} ms on {r['measured_on']}")
    return dry, rep


def script_main(name, argv):
    """``main(argv)`` of ``scripts/<name>.py`` on the card, its standard
    output sent to standard error; returns (what main returned, what the
    script's ``run`` returned inside it, or None where it has none)."""
    mod = load_script(name)
    ran = []
    if hasattr(mod, "run"):
        run = mod.run
        mod.run = lambda args: ran.append(run(args)) or ran[0]
    with contextlib.redirect_stdout(sys.stderr):
        out = mod.main(argv)
    return out, (ran[0] if ran else None)


def check_scripts(dev):
    """Phase [10]: each bench script through its ``main`` on the
    card at its full width, the launch counts reset just before and read
    just after each. Returns ({script: launches}, {script: its result})."""
    import math

    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera
    from openglgaussiansplattingrenderer_tpu_torch.io import native

    launches, outs = {}, {}

    def drive(key, name, argv=()):
        argv = SCRIPT_ARGV[name] + list(argv)
        reset_launches()
        t0 = time.perf_counter()
        out, ran = script_main(name, argv)
        torch.cuda.synchronize()
        launches[key] = read_launches()
        outs[key] = out
        log(f"[10] {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; "
            f"launches {launches[key]}")
        return out, ran

    head, (_, scenes) = drive("flagship_bench", "torch_flagship_bench")
    for r in scenes.values():
        assert r["records"] <= r["capacity"], f"flagship bench {r['scene']}: overflow"
    assert head["metric"] == "fps_flagship_1024x512_fwd", head
    assert head["value"] == min(r["fps"] for r in scenes.values()), head
    outs["flagship_bench"] = dict(head, scenes=scenes)
    log(f"[10] flagship bench: " + ", ".join(
        f"{k} {r['fwd_ms']:.3f} ms ({r['fps']:.2f} fps)" for k, r in scenes.items())
        + f"; headline {head['value']:.2f} fps")

    assert native.available(), "native PLY loader not built"
    out, (_, ex) = drive("scale_test", "torch_scale_test")
    assert ex["written"] is not None, "scale test: the PLY was not written by the script"
    err = float(abs(ex["loaded"]["means"] - ex["written"]["means"]).max())
    log(f"[10] scale test: {out['num_splats']} splats, native load {out['native_load_s']:.2f} s, "
        f"loaded means within {err:.3e} of the written; fwd {out['fwd_ms']:.3f} ms, "
        f"fwd+bwd {out['fwdbwd_ms']:.3f} ms, overflow {out['overflow']}")
    assert err <= 1e-6, f"scale test: loaded means {err:.3e} from the written scene"
    assert out["overflow"] == 0 and out["grads_finite"], out
    del ex

    out, _ = drive("baseline_eval", "torch_baseline_eval")
    c1, c3 = out["config1"], out["config3"]
    log(f"[10] baseline: config 1 ({c1['src']}) {c1['max_abs_diff_vs_golden']:.3e} from "
        f"the golden; config 2 {out['config2']['frame_ms']:.3f} ms; config 3 "
        f"fwd+bwd {c3['fwdbwd_ms']:.3f} ms, worst finite difference "
        f"{c3['worst_rel_err']:.4f}")
    assert c1["max_abs_diff_vs_golden"] <= BASELINE_GOLDEN_TOL, c1
    assert out["config2"]["overflow"] == 0, out["config2"]
    assert c3["worst_rel_err"] <= FD_REL_TOL, c3

    out, _ = drive("radix_sort_bench", "torch_radix_sort_bench")
    for r in out["radix_bench"]:
        log(f"[10] radix sort bench C={r['C']}: torch.sort + gather {r['lax_ms']:.3f} ms, "
            f"radix31 {r['radix31_ms']:.3f}, radix9 {r['radix9_ms']:.3f} ms")
        assert r["radix31_exact"] and r["radix9_exact"], r

    out, (_, ex) = drive("profile_stages", "torch_profile_stages")
    want = ["prep", "cumsum", "expand", "sort2", "full"]
    assert list(out["prefix_ms"]) == want and len(out["bwd_stage_ms"]) == 4, out
    sf, bounds = ex["sort2"]
    assert int(bounds[-1]) == int(ex["full_stats"]["binned_records"]), (
        "profile stages: the sort2 bounds miss the full frame's binned records")
    log(f"[10] profile stages: prefixes " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["prefix_ms"].items())
        + f" ms; compositor alone {out['composite_fwd_ms']:.3f} / fwd+bwd "
        f"{out['composite_fwdbwd_ms']:.3f} ms; full fwd+bwd {out['full_fwdbwd_ms']:.3f} ms")
    prof = load_script("torch_profile_stages")
    pargs = prof.parse_args(SCRIPT_ARGV["torch_profile_stages"])
    frame = Frame(prof.scene_of(pargs), Camera(0.0, 0.0, -8.0, width=pargs.width,
                                               height=pargs.height), ex["cfg"], dev)
    with torch.no_grad():
        check_composite("profile stages, sort2 outputs", frame, records=(sf, bounds))
    del ex, sf, bounds, frame

    out, _ = drive("train_bench", "torch_train_bench")
    curve = out["psnr_curve"]
    log(f"[10] train bench: {out['steps']} steps at CAP {out['cap']}: "
        f"{out['ms_per_step']:.3f} ms a step, PSNR {curve[0]['psnr']:.2f} -> "
        f"{curve[-1]['psnr']:.2f} dB, holdout {out['holdout_psnr']:.2f} dB, alive "
        f"{out['final_alive']}")
    assert curve[-1]["psnr"] > curve[0]["psnr"], "train bench: PSNR did not rise"
    assert out["final_alive"] <= out["cap"], out["final_alive"]
    # every step's backward went through kernels 5 and 3 (two launches)
    n = launches["train_bench"]
    assert n["composite_bwd"] == out["steps"] and n["segsum"] == 2 * out["steps"], n

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "nv.ckpt.npz")
        out, _ = drive("novel_view_bench", "torch_novel_view_bench",
                       ["--ckpt", ckpt, "--grid", os.path.join(tmp, "grid.png")])
        log(f"[10] novel-view bench: {out['steps']} steps, train "
            f"{out['final_train_psnr']:.3f} dB, holdout {out['final_holdout_psnr']:.3f} "
            f"dB, SSIM {out['final_holdout_ssim']:.4f}, alive {out['final_alive']}, "
            f"{out['total_train_s']:.1f} s")
        assert len(out["curve"]) == NV_STEPS // NV_SEGMENT, out["curve"]
        assert math.isfinite(out["final_holdout_psnr"]), out
        ev, _ = drive("nv_holdout_eval", "torch_nv_holdout_eval", ["--ckpt", ckpt])
    gap = abs(ev["holdout_psnr_mean"] - out["final_holdout_psnr"])
    log(f"[10] holdout eval of the bench's checkpoint: {ev['holdout_psnr_mean']:.4f} dB, "
        f"{gap:.3e} dB from the bench's")
    assert ev["step"] == NV_STEPS and gap <= NV_EVAL_TOL_DB, (ev, out)

    for k in STEP_KERNELS + ("radix_counts", "radix_scatter"):
        assert sum(v[k] for v in launches.values()) > 0, (
            f"{k} kernel never launched in phase [10]")
    return launches, outs


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port.")
    ap.add_argument("--cards", type=int, default=0, metavar="N",
                    help="run only phase [9], over N distinct CUDA cards "
                    "(make_mesh(N)); by default every phase runs on one card")
    ap.add_argument("--pg-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import numpy as np  # noqa: F401  (the port needs it; fail early)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.pg_worker:
        pg_worker(args.pg_worker)
        return 0
    import dataclasses

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
    from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded as sh
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
        if "Compiling entry function" in line:
            log(f"[1] ptxas {line.split(chr(39))[1][:110]}")
        elif "Used" in line or "spill" in line:
            log(f"[1] ptxas     {line.replace('ptxas info    :', '').strip()}")

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
    gate_scene = ply_io.make_synthetic_scene(GATE_SPLATS, seed=7, extent=2.5)
    gate = Frame(gate_scene,
                 Camera(0.0, 0.0, -6.0, width=GATE_W, height=GATE_H), gcfg, dev)
    if args.cards:
        del frames
        mesh_launches, mesh_nums = check_multi_device(scenes, gate, dev,
                                                      sh.make_mesh(args.cards))
        mesh_nums["cli"] = check_parallel_cli(dev, args.cards)
        mesh_nums["dryrun"], mesh_nums["scaling"] = check_dryrun_and_scaling(args.cards)
        log(f"[7] card and power limit, again beside the results: {card}")
        log(json.dumps({"multi_device": mesh_nums, "launches": mesh_launches}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. kernels against their plain versions --------------------------
    results = {}
    with torch.no_grad():
        # kernels 10 and 11, the splat table, on the uniform frame's
        # parameters, the main path's; the clustered frame's, an SH-3
        # variant of the uniform one (sh_rest drawn from TABLE_SH_SEED) and
        # the gate scene's ride along
        fwd, bwd = check_splat_table("uniform flagship", frames["uniform"])
        sh3 = frames["uniform"].with_cfg(
            dataclasses.replace(frames["uniform"].cfg, sh_degree=3))
        gen = torch.Generator(device=dev).manual_seed(TABLE_SH_SEED)
        sh3.params = dict(frames["uniform"].params, sh_rest=TABLE_SH_SCALE * torch.randn(
            (FLAG_SPLATS, 45), generator=gen, device=dev))
        rides = {"clustered": check_splat_table("clustered flagship", frames["clustered"]),
                 "sh3": check_splat_table("uniform flagship SH-3", sh3),
                 "gate_scene": check_splat_table(f"gate scene ({GATE_SPLATS} splats)", gate)}
        del sh3
        results["splat_table"] = dict(fwd, **{k: v[0] for k, v in rides.items()})
        results["splat_table_bwd"] = dict(bwd, **{k: v[1] for k, v in rides.items()})
        check_scan(frames["uniform"], results)
        # kernels 2 and 3 on the uniform frame's table, the main path's; the
        # clustered frame's and (phase 6) the 1080p scene's ride along
        results["expand"], results["segsum"] = check_expand_segsum(
            "uniform flagship", frames["uniform"])
        cl_exp, cl_seg = check_expand_segsum("clustered flagship", frames["clustered"])
        results["expand"]["clustered"], results["segsum"]["clustered"] = cl_exp, cl_seg
        check_radix(frames["uniform"], results)
        # the record sort stage on the uniform frame's records, pair (the
        # main path's) and packed; the clustered frame's and (phase 6) the
        # 1080p scene's ride along
        rsort = {k: check_record_sort(f"{k} flagship", frames[k])
                 for k in ("uniform", "clustered")}
        results["record_sort"] = dict(
            rsort["uniform"]["pair"][0], packed=rsort["uniform"]["packed"][0],
            clustered=rsort["clustered"]["pair"][0],
            clustered_packed=rsort["clustered"]["packed"][0],
            sources=list(RECORD_SORT_SOURCES))
        results["record_unsort"] = dict(
            rsort["uniform"]["pair"][1], packed=rsort["uniform"]["packed"][1],
            clustered=rsort["clustered"]["pair"][1],
            clustered_packed=rsort["clustered"]["packed"][1])
        del rsort
        # kernels 4 and 5 at the main path's shapes; the gate scene's and
        # the clustered frame's numbers ride along under their names
        fwd, bwd = check_composite("uniform flagship", frames["uniform"])
        gate_fwd, gate_bwd = check_composite(
            f"gate scene ({GATE_SPLATS} splats)", gate)
        # and where one tile holds most of the frame's records
        cl_fwd, cl_bwd = check_composite("clustered flagship", frames["clustered"],
                                         plain_once=True)
        results["composite"] = dict(fwd, gate_scene=gate_fwd, clustered=cl_fwd)
        results["composite_bwd"] = dict(bwd, gate_scene=gate_bwd, clustered=cl_bwd)

        # ---- 3. the render path --------------------------------------------
        reset_launches()
        img_u, _ = check_frame("uniform pair", frames["uniform"])
        packed = dataclasses.replace(frames["uniform"].cfg, depth_key="packed")
        img_p, _ = check_frame("uniform packed", frames["uniform"].with_cfg(packed))
        check_frame("clustered pair", frames["clustered"])
        render_launches = read_launches()
        log(f"[3] kernel launches on the render path: {render_launches}")
        reset_launches()
        frames["uniform"].render()
        one = read_launches()
        assert one["splat_table"] == 1 and one["splat_table_bwd"] == 0, (
            f"one frame launched the splat table kernels {one}")
        for k in FRAME_KERNELS:
            assert render_launches[k] > 0, (
                f"{k} kernel never launched on the render path")
        for k in ("radix_counts", "radix_scatter"):
            assert render_launches[k] == 0, f"{k} launched on the torch.sort path"
        # the record sort stage: one count, a scatter a pass, one gather a frame
        assert one["record_sort"] == 2 + sum(rs.passes(frames["uniform"].cfg.num_tiles,
                                                        "pair")), one
        assert one["record_unsort"] == 0, one
        results["record_sort"]["routes"] = check_sort_routes(frames["uniform"], img_u)
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

    # ---- 3a. the kernels against the oracle ------------------------------
    t0 = time.perf_counter()
    oracle_launches, oracle = check_oracle(gate, frames["uniform"])
    log(f"[3a] kernel launches in the oracle phase: {oracle_launches}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 4. stage times of one forward + backward ------------------------
    for name in ("uniform", "clustered"):
        stage_times(f"{name} pair", frames[name])

    # ---- 5. the training path -------------------------------------------
    launches, train_ms = check_training(frames["uniform"])

    # ---- 5b. adaptive density control at capacity, and the training CLI ---
    t0 = time.perf_counter()
    densify_launches = check_densify(frames["uniform"], fcam, train_ms)
    # the uniform flagship as a PLY, for the training CLI and the viewer phase
    ply_dir = tempfile.TemporaryDirectory()
    flag_ply = os.path.join(ply_dir.name, "flagship.ply")
    t1 = time.perf_counter()
    sc = scenes["uniform"]
    ply_io.save_ply(flag_ply, sc["means"], sc["quats"], sc["scales"], sc["opacities"],
                    sc["colors"])
    log(f"[5b] flagship PLY written in {time.perf_counter() - t1:.1f} s "
        f"({os.path.getsize(flag_ply) / 2**20:.0f} MiB)")
    cli_launches = check_cli(flag_ply, dev)
    log(f"[5b] the phase took {time.perf_counter() - t0:.1f} s")

    # ---- 6. forward + backward of the other scenes ------------------------
    check_fwdbwd("uniform pair", frames["uniform"])
    check_fwdbwd("clustered pair", frames["clustered"])
    del frames
    mcfg0 = RenderConfig.for_resolution(MSPLATS_W, MSPLATS_H, tile_px=32,
                                        chunk=MSPLATS_CHUNK)
    msplats = Frame(
        ply_io.make_synthetic_scene(MSPLATS, seed=42, extent=3.0,
                                    log_scale_range=(-5.5, -3.2)),
        Camera(0.0, 0.0, -8.0, width=MSPLATS_W, height=MSPLATS_H), mcfg0, dev)
    msplats.cfg = autotune_capacity(msplats.params, *msplats.args[:6], MSPLATS_W,
                                    MSPLATS_H, mcfg0)
    with torch.no_grad():
        hd_exp, hd_seg = check_expand_segsum(f"{MSPLATS} splats {MSPLATS_W}x{MSPLATS_H}",
                                             msplats)
        # the packed key holds at most 512 tiles; 1080p has 2,040
        hd_sort = check_record_sort(f"{MSPLATS} splats {MSPLATS_W}x{MSPLATS_H}", msplats,
                                    keys=("pair",))["pair"]
    results["expand"]["hd"], results["segsum"]["hd"] = hd_exp, hd_seg
    results["record_sort"]["hd"], results["record_unsort"]["hd"] = hd_sort
    reset_launches()
    check_fwdbwd(f"{MSPLATS} splats {MSPLATS_W}x{MSPLATS_H}", msplats)
    hd_launches = read_launches()
    assert hd_launches["record_sort"] > 0 and hd_launches["record_unsort"] > 0, hd_launches
    log(f"[6] kernel launches of the 1080p forward + backward runs: {hd_launches}")
    stage_times(f"{MSPLATS} splats {MSPLATS_W}x{MSPLATS_H}", msplats)
    check_small_gradients(dev)

    # ---- 8. the viewer, the render CLI and the fps bench --------------------
    t0 = time.perf_counter()
    viewer_launches, viewer_nums = check_viewer(flag_ply, gate_scene, dev)
    ply_dir.cleanup()
    log(f"[8] the phase took {time.perf_counter() - t0:.1f} s")

    # ---- 9. the multi-device layer, four shards on the one card -------------
    t0 = time.perf_counter()
    mesh_launches, mesh_nums = check_multi_device(
        scenes, gate, dev, sh.make_mesh(devices=["cuda:0"] * MESH_SHARDS))
    del scenes
    mesh_nums["cli"] = check_parallel_cli(dev, 1)
    mesh_nums["dryrun"], mesh_nums["scaling"] = check_dryrun_and_scaling(1)
    log(f"[9] the phase took {time.perf_counter() - t0:.1f} s")

    # ---- 10. the scripts -----------------------------------------------------
    t0 = time.perf_counter()
    script_launches, script_nums = check_scripts(dev)
    log(f"[10] the phase took {time.perf_counter() - t0:.1f} s")

    # ---- 2, continued: the probe kernels (3.2 GB written a launch, and a
    # rebuild of the library: kept behind every time of the main paths) -----
    with torch.no_grad():
        probe_launches = check_probes(results)

    # ---- 7. results ---------------------------------------------------------
    # "launches" counts the training path's five steps for the kernels of
    # the frame and its backward, one hoisted + radix frame for the two
    # radix-sort kernels and one run of its probe for each probe kernel; the
    # default render path's three frames (and their timing repetitions) and
    # one packed + radix frame are counted beside it
    launches.update({k: sort_launches["hoisted+radix"][k]
                     for k in ("radix_counts", "radix_scatter")})
    launches.update({k: probe_launches[k] for k in ("bucketer_level", "probe_affine")})
    rows = []
    for name, (src, replaces) in KERNELS.items():
        assert launches[name] > 0, f"{name} kernel never launched on its path"
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "render_path_launches": render_launches[name],
                     "radix_frame_launches": sort_launches["packed+radix"][name],
                     "oracle_phase_launches": oracle_launches[name],
                     "densify_phase_launches": densify_launches[name],
                     "cli_ply_launches": cli_launches["ply"][name],
                     "cli_colmap_launches": cli_launches["colmap"][name],
                     "viewer_launches": viewer_launches["viewer"][name],
                     "cli_launches": sum(viewer_launches[r][name] for r in CLI_ROUTES),
                     "sharded_launches": mesh_launches["sharded"][name],
                     "sharded_train_launches": mesh_launches["sharded_train"][name],
                     "dp_launches": mesh_launches["dp"][name],
                     "mesh2d_launches": mesh_launches["mesh2d"][name],
                     "mesh2d_fit_launches": mesh_launches["mesh2d_fit"][name],
                     "pg_frame_launches": mesh_launches["pg_frame"][name],
                     "pg_step_launches": mesh_launches["pg_step"][name],
                     "scripts_launches": sum(v[name] for v in script_launches.values()),
                     **results[name]})
    log(f"[7] card and power limit, again beside the results: {card}")
    log(json.dumps({"oracle": oracle}))
    log(json.dumps({"viewer": viewer_nums, "multi_device": mesh_nums}))
    log(json.dumps({"scripts": script_nums, "launches": script_launches}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
