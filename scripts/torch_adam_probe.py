#!/usr/bin/env python3
"""Where the port's Adam step (``csrc/adam.cu`` behind
``ops/kernels/adam.py`` ``adam_update``) spends its time, on one NVIDIA GPU.

    python3 scripts/torch_adam_probe.py [--splats 3616103] [--reps 200]
    python3 scripts/torch_adam_probe.py --root DIR --earlier-parts   # the earlier wrapper

On ``chip_smoke.py``'s Adam case (seeded raw tensors, gradients and
moments three steps in, of ``--splats`` splats, SH 0 keys and SH 3 keys)
it prints JSON lines:

- ``host``: the wrapper's host time split into its parts, each timed with
  ``time.perf_counter_ns`` around the same statements the wrapper runs, in
  its order, and the whole wrapper's host time (the call's return), the
  two in turn (medians of ``--reps`` calls); with ``--earlier-parts``, PR
  17's wrapper's parts
  (on a checkout whose ``ops/kernels/adam.py`` still has ``adam_args``);
- ``forms``: the kernel's forms, each launched through its own C entry
  point on arguments built once (the kernel alone, no wrapper), held
  bit-equal to ``adam_update_plain`` and its addition (p', m', v'), and
  timed in turn (each form, then each again in reverse order): on the
  device alone, warm and cold (torch.profiler's records, mean of 20
  launches), and between CUDA events around one launch (median of 15).
  The forms: the tree's (``csrc/adam.cu``: a block a chunk of 4,096
  elements, a thread's four groups one after another, 3 blocks an SM),
  the same at 2, 4 and 8 blocks an SM (8: no shared memory reserved), the
  same with its arithmetic replaced by copies (not held to the plain step: the rate the
  card gives these four reads and three writes), the two not taken: a
  persistent grid streaming 8 KB chunks through a shared-memory ring by
  TMA bulk copies (``scripts/adam_probe_stream.cu``; and with 16 KB chunks)
  and restrict pointers with all of a thread's loads first and streaming
  hints (``scripts/adam_probe_loads_first.cu``, 8 groups a thread; and 4),
  and the earlier kernel (``scripts/adam_probe_earlier.cu``: 4,096-element
  blocks numbered key after key, seven pointer arrays that may alias);
- ``ceilings``: ``copy_`` and ``add`` at Adam's bytes, on the device
  alone, with the rate each moves.

With ``--in-step`` it prints only ``in_step_device_us``: each of
``STEP_FORMS`` as the kernel of ``chip_smoke.py``'s phase-[5] train step
(``adam_update`` planning with the form's chunk and launching the form),
Adam's device time a step, in turn; the steps' losses held bit for bit.

Needs a card and nvcc; the variants are built under ``build/``
(git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EARLIER = ROOT / "scripts" / "adam_probe_earlier.cu"
STREAM = ROOT / "scripts" / "adam_probe_stream.cu"
LOADS_FIRST = ROOT / "scripts" / "adam_probe_loads_first.cu"

ADAM_COUNT, ADAM_SEED = 3, 21          # chip_smoke.py's Adam case
WIDTHS = {"means": (3,), "log_scales": (3,), "quats": (4,), "logit_opacities": (),
          "colors": (3,)}


def case(n: int, sh: bool, device):
    """(raw, grads, state ADAM_COUNT steps in, rates) of ``n`` splats, as
    ``chip_smoke.adam_case`` draws them."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizer,
    )

    widths = dict(WIDTHS, **({"sh_rest": (15, 3)} if sh else {}))
    gen = torch.Generator(device=device).manual_seed(ADAM_SEED)

    def draw(w, scale):
        return torch.randn((n, *w), generator=gen, device=device) * scale

    raw = {k: draw(w, 1.0) for k, w in widths.items()}
    grads = {k: draw(w, 1e-3) for k, w in widths.items()}
    state = {"count": ADAM_COUNT, "mu": {k: draw(w, 1e-3) for k, w in widths.items()},
             "nu": {k: draw(w, 1e-4).abs() for k, w in widths.items()}}
    opt = make_optimizer(TrainConfig(lr_means_final=1.6e-6, lr_means_decay_steps=30_000),
                         tuple(widths))
    return raw, grads, state, {k: opt.learning_rate(k, ADAM_COUNT) for k in widths}


def parts_tree(grads, opt_state, lrs, raw):
    """The tree's ``adam_update`` on CUDA tensors, statement for statement,
    with a ``perf_counter_ns`` stamp after each part: {part: ns} and the
    outputs. The views are made after the launch, as the wrapper makes
    them."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    now = time.perf_counter_ns
    t = [now()]
    p, ins, ptrs = kadam.plan(grads, opt_state, lrs, raw)
    t.append(now())
    assert p is not None and p is not kadam._CPU
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        raise NotImplementedError("adam")
    lib = kadam._library()
    count = opt_state["count"]
    t.append(now())
    buf = ins[1].new_empty(p.total)
    t.append(now())
    with kadam._LOCK:
        kadam.step_args(p.args, ptrs, buf.data_ptr(), lrs, count)
        t.append(now())
        stream = build.stream_ptr()
        t.append(now())
        build.check("adam", lib.gs_adam_step(p.addr, stream))
        t.append(now())
    outs = [buf.as_strided(*v) for v in p.views]
    n = len(p.keys)
    res = (dict(zip(p.keys, outs[:n])), dict(zip(p.keys, outs[n:2 * n])),
           dict(zip(p.keys, outs[2 * n:])))
    t.append(now())
    names = ("plan (inputs, pointers, key, lookup)", "grad check, library", "allocation",
             "step_args", "stream_ptr", "ctypes call", "views (after the launch)")
    return dict(zip(names, (b - a for a, b in zip(t, t[1:])))), res


def parts_earlier(grads, opt_state, lrs, raw):
    """The earlier ``adam_update`` (its ``AdamArgs`` filled item by item by
    ``adam_args``) on CUDA tensors, statement for statement,
    with a ``perf_counter_ns`` stamp after each part: {part: ns} and the
    outputs."""
    import ctypes

    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    now = time.perf_counter_ns
    t = [now()]
    keys = list(lrs)
    m_in, v_in = opt_state["mu"], opt_state["nu"]
    every = [d[k] for d in (grads, m_in, v_in, raw) for k in keys]
    assert build.on_cuda("adam", *every)
    t.append(now())
    tensors, out, mu, nu, ins_of = {}, {}, {}, {}, {}
    for k in keys:
        g = grads[k].contiguous()
        ins = [raw[k].contiguous(), g, m_in[k].contiguous(), v_in[k].contiguous()]
        for name, x in zip(("raw", "grad", "mu", "nu"), ins):
            if x.dtype != torch.float32 or x.shape != g.shape:
                raise ValueError(name)
        ins_of[k] = ins
    t.append(now())
    for k in keys:
        g = ins_of[k][1]
        out[k], mu[k], nu[k] = (torch.empty_like(g) for _ in range(3))
        tensors[k] = (*ins_of[k], out[k], mu[k], nu[k])
    t.append(now())
    count = opt_state["count"]
    c1, c2 = kadam.bias_corrections(count)
    t.append(now())
    a = kadam.AdamArgs(b1=kadam.ADAM_B1, one_minus_b1=1.0 - kadam.ADAM_B1, b2=kadam.ADAM_B2,
                       one_minus_b2=1.0 - kadam.ADAM_B2, inv_c1=1.0 / c1, inv_c2=1.0 / c2,
                       eps=kadam.ADAM_EPS, keys=len(lrs))
    for i, (k, lr) in enumerate(lrs.items()):
        ts = tensors[k]
        for name, x in zip(("p", "g", "m", "v", "p_out", "m_out", "v_out"), ts):
            getattr(a, name)[i] = x.data_ptr()
        a.n[i] = ts[1].numel()
        a.neg_lr[i] = -lr
    t.append(now())
    lib = kadam._library()
    stream = build.stream_ptr()
    t.append(now())
    build.check("adam", lib.gs_adam_step(ctypes.addressof(a), stream))
    t.append(now())
    names = ("device check", "contiguous and checks", "allocations", "bias_corrections",
             "adam_args", "stream_ptr", "ctypes call")
    return dict(zip(names, (b - a for a, b in zip(t, t[1:])))), (out, mu, nu)


def host_parts(parts_fn, whole_fn, grads, state, lrs, raw, reps: int) -> dict:
    """Median us of each part of ``parts_fn`` and of one whole call of
    ``whole_fn`` (its return, the device not waited for), the two called in
    turn ``reps`` times each after 10, so that both see the same host; the
    device synchronised every 10 calls outside the clocks."""
    import torch

    got = {}
    now = time.perf_counter_ns
    for i in range(reps + 10):
        if i % 10 == 0:
            torch.cuda.synchronize()
        parts, _ = parts_fn(grads, state, lrs, raw)
        t0 = now()
        whole_fn(grads, state, lrs, raw)
        parts["whole wrapper"] = now() - t0
        if i >= 10:
            for k, v in parts.items():
                got.setdefault(k, []).append(v)
    torch.cuda.synchronize()
    med = {k: statistics.median(v) / 1e3 for k, v in got.items()}
    split = [k for k in med if k != "whole wrapper"]
    med["sum of parts"] = sum(med[k] for k in split)
    med["before the launch"] = sum(med[k] for k in split if "after the launch" not in k)
    return med


# ---- the kernel's forms ---------------------------------------------------

# name: (source appended to csrc/adam.cu or the earlier source or None, (text,
# replacement) edits, C entry point, chunk, blocks an SM of a persistent
# grid or None, held to the plain step)
COPIES = (("adam_four(a, s.neg_lr, p, g, m, v, x, y, z);",
           "x = p; x.x += g.x; y = m; z = v;"),)


def _stream(chunk, stages, per_sm):
    return (STREAM, (("constexpr int kStreamChunk = 2048;",
                      f"constexpr int kStreamChunk = {chunk};"),
                     ("constexpr int kStages = 3;", f"constexpr int kStages = {stages};"),
                     ("constexpr int kStreamPerSm = 2;",
                      f"constexpr int kStreamPerSm = {per_sm};")),
            "gs_adam_step_stream", chunk, per_sm, True)


def _kept_per_sm(per_sm):
    return (None, (("constexpr int kBlocksPerSm = 3;",
                    f"constexpr int kBlocksPerSm = {per_sm};"),),
            "gs_adam_step", 4096, None, True)


KEPT, STREAM_FORM, LOADS_FIRST_FORM, EARLIER_FORM = (
    "kept (tree)", "stream (not taken)", "loads first (not taken)", "the earlier kernel")
FORMS = {
    KEPT: (None, (), "gs_adam_step", 4096, None, True),
    "kept, 2 blocks an SM": _kept_per_sm(2),
    "kept, 4 blocks an SM": _kept_per_sm(4),
    "kept, 8 blocks an SM": (None, (("  adam_step<<<a.blocks, kThreads, kReserveBytes,",
                                     "  adam_step<<<a.blocks, kThreads, 0,"),),
                             "gs_adam_step", 4096, None, True),
    "kept, copies only (timing)": (None, COPIES, "gs_adam_step", 4096, None, False),
    STREAM_FORM: _stream(2048, 3, 2),
    "stream 4096 x 3 stages, 1 an SM": _stream(4096, 3, 1),
    LOADS_FIRST_FORM: (LOADS_FIRST, (), "gs_adam_step_loads_first", 8192, None, True),
    "loads first, 4 groups a thread": (LOADS_FIRST, (("constexpr int kLoadGroups = 8;",
                                                      "constexpr int kLoadGroups = 4;"),),
                                       "gs_adam_step_loads_first", 4096, None, True),
    EARLIER_FORM: (EARLIER, (), "gs_adam_step", None, None, True),
}
# chip_smoke.py's phase [2] times these in turn; --in-step these
TURN_FORMS = (KEPT, STREAM_FORM, LOADS_FIRST_FORM, EARLIER_FORM)
STEP_FORMS = (KEPT, "kept, 2 blocks an SM", "kept, 4 blocks an SM", "kept, 8 blocks an SM",
              STREAM_FORM, LOADS_FIRST_FORM, "loads first, 4 groups a thread", EARLIER_FORM)


def form_source(name: str) -> str:
    """The CUDA source of form ``name``: the earlier kernel's as it is, else
    csrc/adam.cu with the form's source appended and its edits made (each
    edit's text must be there)."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    extra, edits = FORMS[name][:2]
    if extra == EARLIER:
        return EARLIER.read_text()
    text = (build.CSRC / "adam.cu").read_text()
    if extra is not None:
        text += "\n" + extra.read_text()
    for a, b in edits:
        if a not in text:
            raise ValueError(f"form {name!r}: {a!r} is not in its source")
        text = text.replace(a, b)
    return text


def library(name: str):
    """(ctypes library of form ``name``, ptxas lines) built alone in a copy
    under build/."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    d = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    (d / "adam.cu").write_text(form_source(name))
    path, _, ptx = build.build_library(d, d / "out")
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, FORMS[name][2])
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    lib.entry = fn
    return lib, [ln.split(":")[-1].strip() for ln in ptx.splitlines() if "Used" in ln]


class EarlierArgs(ctypes.Structure):
    """The earlier kernel's AdamArgs (scripts/adam_probe_earlier.cu)."""
    _fields_ = [(name, ctypes.c_void_p * 8) for name in (
        "p", "g", "m", "v", "p_out", "m_out", "v_out")] + [
        ("n", ctypes.c_longlong * 8), ("first_block", ctypes.c_longlong * 9),
        ("neg_lr", ctypes.c_float * 8), ("vec", ctypes.c_int * 8)] + [
        (name, ctypes.c_float) for name in (
            "b1", "one_minus_b1", "b2", "one_minus_b2", "inv_c1", "inv_c2", "eps")] + [
        ("keys", ctypes.c_int)]


class Launch:
    """One form's launch on a case, its arguments built once: the outputs
    (p', m', v' of every key) in one allocation laid out as the tree's
    wrapper lays them out."""

    def __init__(self, name, lib, raw, grads, state, lrs):
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam

        chunk, per_sm = FORMS[name][3:5]
        keys = list(lrs)
        ins = [d[k] for k in keys for d in (raw, grads, state["mu"], state["nu"])]
        ptrs = [t.data_ptr() for t in ins]
        mis = kadam.misaligned_keys(ptrs)
        a = kadam.plan_args([grads[k].numel() for k in keys],
                            [not mis >> i & 1 for i in range(len(keys))], chunk or kadam.CHUNK)
        if per_sm:
            sms = torch.cuda.get_device_properties(ins[0].device).multi_processor_count
            a.blocks = min(a.blocks, per_sm * sms)
        self.buf = torch.empty(3 * a.role_stride, device=ins[0].device)
        kadam.step_args(a, ptrs, self.buf.data_ptr(), lrs, state["count"])
        self.outs = [[self.buf.as_strided(grads[k].shape, grads[k].stride(),
                                          r * a.role_stride + a.out_at[i])
                      for i, k in enumerate(keys)] for r in range(3)]
        if FORMS[name][0] == EARLIER:
            old = EarlierArgs(b1=a.b1, one_minus_b1=a.one_minus_b1, b2=a.b2,
                           one_minus_b2=a.one_minus_b2, inv_c1=a.inv_c1, inv_c2=a.inv_c2,
                           eps=a.eps, keys=a.keys)
            for i in range(len(keys)):
                for j, role in enumerate(("p", "g", "m", "v")):
                    getattr(old, role)[i] = ptrs[4 * i + j]
                for r, role in enumerate(("p_out", "m_out", "v_out")):
                    getattr(old, role)[i] = self.outs[r][i].data_ptr()
                old.n[i], old.neg_lr[i] = a.n[i], a.neg_lr[i]
            a = old
        self.args, self.addr, self.lib, self.keys = a, ctypes.addressof(a), lib, keys

    def __call__(self):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

        build.check("adam form", self.lib.entry(self.addr, build.stream_ptr()))

    def equal_to_plain(self, raw, grads, state, lrs) -> bool:
        """p', m', v' bit-equal to adam_update_plain and its addition."""
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam

        self.buf.fill_(float("nan"))
        self()
        upd, st = kadam.adam_update_plain(grads, state, lrs)
        return all(torch.equal(self.outs[0][i], raw[k] + upd[k])
                   and torch.equal(self.outs[1][i], st["mu"][k])
                   and torch.equal(self.outs[2][i], st["nu"][k])
                   for i, k in enumerate(self.keys))


def kernel_device_us(fn, calls: int = 20, tries: int = 3, name: str = "adam"):
    """Mean device time of one call of ``fn`` in us: the sum of its kernel
    records whose name holds ``name`` (torch.profiler) over ``calls``
    calls. The profiler at times loses records: each run starts and ends
    with a spin kernel (as ``chip_smoke.device_us`` does) and counts only
    if it holds ``calls`` such records; else None after ``tries`` runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        got = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and name in e.name.lower()
               and not getattr(e, "is_user_annotation", False)]
        if len(got) == calls:
            return sum(got) / calls
    return None


def events_ms(fn, reps: int = 15) -> float:
    """Median of ``reps`` calls of ``fn`` between CUDA events, after two."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def build_forms(names):
    """{name: (library, ptxas lines)} of the forms, built at once; a form
    that does not build is reported and left out."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    def one(name):
        try:
            return library(name)
        except build.KernelBuildError as e:
            print(json.dumps({"form not built": name, "error": str(e)[-2000:]}), flush=True)
            return None

    (ROOT / "build").mkdir(exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        return {n: lib for n, lib in zip(names, pool.map(one, names)) if lib is not None}


def time_forms(libs, raw, grads, state, lrs) -> dict:
    """Each form of ``libs`` held bit-equal to the plain step, then timed in
    turn: every form, then every form again in reverse order, on the
    device alone warm (launch after launch) and cold (a 1 GiB fill between
    launches, as the train step's other kernels come between its Adam
    launches: the caches and the translation lookaside buffers no longer
    hold Adam's arrays), and between events. {name: {"equal", "device_us":
    [two], "cold_device_us": [two], "events_ms": [two], "ptxas"}}."""
    import torch

    out = {}
    launches = {}
    for name, (lib, ptx) in libs.items():
        launches[name] = Launch(name, lib, raw, grads, state, lrs)
        out[name] = {"equal": (launches[name].equal_to_plain(raw, grads, state, lrs)
                               if FORMS[name][5] else None),
                     "device_us": [], "cold_device_us": [], "events_ms": [], "ptxas": ptx}
        torch.cuda.empty_cache()
    flush = torch.empty(1 << 28, device=next(iter(raw.values())).device)
    order = list(libs)
    for name in order + order[::-1]:
        launch = launches[name]

        def cold():
            flush.zero_()
            launch()

        out[name]["device_us"].append(kernel_device_us(launch))
        out[name]["cold_device_us"].append(kernel_device_us(cold))
        out[name]["events_ms"].append(events_ms(launch))
    return out


def ceilings(elements: int) -> dict:
    """What the card's memory moves for torch's own streaming kernels at
    Adam's size: ``copy_`` (a read and a write an element) and ``add``
    (two reads and a write) over float32 arrays of ``elements`` x 28 / 8
    and x 28 / 12 elements (Adam's 28 B an element in all), on the device
    alone: {name: (us, TB/s)}."""
    import torch

    out = {}
    n = elements * 28 // 8
    a, b = torch.empty(n, device="cuda"), torch.empty(n, device="cuda")
    us = kernel_device_us(lambda: b.copy_(a), name="memcpy")
    out["copy_"] = (us, 8 * n / us / 1e6 if us else None)
    del a, b
    n = elements * 28 // 12
    a, b, c = (torch.ones(n, device="cuda") for _ in range(3))
    us = kernel_device_us(lambda: torch.add(a, b, out=c), name="add")
    out["add"] = (us, 12 * n / us / 1e6 if us else None)
    del a, b, c
    torch.cuda.empty_cache()
    return out


class FormInStep:
    """Stands in for the tree's kernel library inside ``adam_update``: its
    ``gs_adam_step`` launches form ``name`` on the struct the wrapper
    planned (with the form's chunk) and filled; the earlier kernel gets the
    same pointers and scalars in its own struct."""

    def __init__(self, name, lib, sms):
        self.name, self.lib, self.sms = name, lib, sms

    def gs_adam_step(self, addr, stream):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam

        a = kadam.AdamArgs.from_address(addr)
        per_sm = FORMS[self.name][4]
        if per_sm:
            a.blocks = min(a.blocks, per_sm * self.sms)
        if FORMS[self.name][0] != EARLIER:
            return self.lib.entry(addr, stream)
        old = EarlierArgs(b1=a.b1, one_minus_b1=a.one_minus_b1, b2=a.b2,
                       one_minus_b2=a.one_minus_b2, inv_c1=a.inv_c1, inv_c2=a.inv_c2,
                       eps=a.eps, keys=a.keys)
        for i in range(a.keys):
            for j, role in enumerate(("p", "g", "m", "v")):
                getattr(old, role)[i] = a.inputs[4 * i + j]
            for r, role in enumerate(("p_out", "m_out", "v_out")):
                getattr(old, role)[i] = a.out + 4 * (a.out_at[i] + r * a.role_stride)
            old.n[i], old.neg_lr[i] = a.n[i], a.neg_lr[i]
        return self.lib.entry(ctypes.addressof(old), stream)


def in_step(libs, splats: int, steps: int = 5) -> dict:
    """Each form of ``libs`` as the kernel of the uniform flagship's train
    step (``chip_smoke.py``'s phase [5]: ``splats`` splats at 1024x512,
    colours perturbed, L1 + 0.2 D-SSIM with the densification statistic):
    Adam's device time a step (torch.profiler, mean over ``steps`` steps),
    in turn (each form, then each again in reverse order), each form's
    losses of two steps held to the tree's bit for bit. {name: [two us]}."""
    import functools

    import numpy as np
    import torch

    import openglgaussiansplattingrenderer_tpu_torch as port
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam
    from openglgaussiansplattingrenderer_tpu_torch.render import (
        autotune_capacity,
        camera_args,
        render_arrays,
    )
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        raw_from_params,
    )

    dev = torch.device("cuda")
    w, h = 1024, 512
    scene = ply_io.make_synthetic_scene(splats, seed=99, extent=3.0,
                                        log_scale_range=(-5.8, -3.6))
    params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"}, dev)
    a = camera_args(port.Camera(0.0, 0.0, -8.0, width=w, height=h))
    cam = (torch.as_tensor(a["view"], device=dev), torch.as_tensor(a["vp"], device=dev),
           a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])
    cfg = autotune_capacity(params, *cam, w, h,
                            port.RenderConfig.for_resolution(w, h, tile_px=32, chunk=256))
    with torch.no_grad():
        target = render_arrays(params, *cam, w, h, cfg)[0][..., :3].contiguous()
    colors = params["colors"].cpu().numpy()
    noisy = np.clip(colors + np.random.default_rng(0).normal(0, 40, colors.shape),
                    5, 250).astype(np.float32)
    step = make_train_step(cfg, TrainConfig(lambda_dssim=0.2), w, h, with_grad_norms=True)
    with torch.no_grad():
        start = step.init(raw_from_params(dict(params, colors=torch.as_tensor(noisy,
                                                                            device=dev))))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    library, plan_args = kadam._library, kadam.plan_args
    out = {name: [] for name in libs}
    want = None
    try:
        for name in list(libs) + list(libs)[::-1]:
            form = FormInStep(name, libs[name][0], sms)
            kadam._library = lambda: form
            kadam.plan_args = functools.partial(plan_args, chunk=FORMS[name][3] or kadam.CHUNK)
            kadam._PLANS.clear()
            state = start
            losses = []
            for _ in range(2):
                state, metrics = step(state, target, *cam)
                losses.append(float(metrics["loss"]))
            if want is None:
                want = losses
            assert losses == want, (name, losses, want)

            def one():
                nonlocal state
                state, _ = step(state, target, *cam)

            out[name].append(kernel_device_us(one, calls=steps))
    finally:
        kadam._library, kadam.plan_args = library, plan_args
        kadam._PLANS.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splats", type=int, default=3_616_103)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose package is imported (default: this one)")
    ap.add_argument("--earlier-parts", action="store_true",
                    help="split the earlier wrapper (on a checkout of it) instead")
    ap.add_argument("--no-forms", action="store_true", help="the host split only")
    ap.add_argument("--in-step", action="store_true",
                    help="only each turn form's device time inside the train step")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_adam_probe: no CUDA device", file=sys.stderr)
        return 1
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.in_step:
        libs = build_forms(list(STEP_FORMS))
        print(json.dumps({"in_step_device_us": in_step(libs, args.splats)}), flush=True)
        return 0
    libs = None if args.no_forms or args.earlier_parts else build_forms(list(FORMS))
    parts = parts_earlier if args.earlier_parts else parts_tree
    for name, sh in (("sh0", False), ("sh3", True)):
        raw, grads, state, lrs = case(args.splats, sh, dev)
        _, (out, mu, nu) = parts(grads, state, lrs, raw)
        new, st = kadam.adam_update(grads, state, lrs, raw)
        for k in lrs:
            assert torch.equal(out[k], new[k]) and torch.equal(mu[k], st["mu"][k])
            assert torch.equal(nu[k], st["nu"][k])
        del out, mu, nu, new, st
        with torch.no_grad():                       # as the train step calls it
            row = {"case": name, "elements": sum(v.numel() for v in raw.values()),
                   "keys": len(lrs), "parts_us": host_parts(
                       parts, kadam.adam_update, grads, state, lrs, raw, args.reps)}
        print(json.dumps({"host": row}), flush=True)
        if libs:
            print(json.dumps({"forms": dict(case=name, **time_forms(
                libs, raw, grads, state, lrs))}), flush=True)
            elements = row["elements"]
            del raw, grads, state
            torch.cuda.empty_cache()
            print(json.dumps({"ceilings": dict(case=name, **ceilings(elements))}), flush=True)
            continue
        del raw, grads, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
