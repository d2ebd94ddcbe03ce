"""One Adam step over every raw tensor of a train step.

The JAX package takes it with optax's ``adam`` (``train/trainer.py``
``make_optimizer``), which XLA fuses; no Pallas kernel. The kernel is
``csrc/adam.cu``: one launch for all keys (multi-tensor apply), each
element's p, g, m and v read once and p', m' and v' written once, every
float rounded as ``adam_update_plain``'s torch calls round on the card, so
the two are bit-equal there. The step is functional: p', m' and v' are new
tensors, and the state passed in is not written.

The wrapper's host path is short because little of it runs each step. A
launch plan (``Plan``: the kernel's argument struct with the keys' lengths,
the chunk layout, each key's path and where its outputs lie, and the
outputs' views) is cached on what it depends on: the keys, each input's
shape, dtype and device, whether all are contiguous, and which keys have an
input off the 16-byte grid. Each step writes only the input pointers (one
slice assignment), the outputs' base, each key's ``-lr`` and the bias
corrections' reciprocals (memoized by ``count``) into the cached struct,
allocates every output in one ``torch.empty`` and launches; the outputs'
views are made after the launch, while the kernel runs. The views share one
storage (every key's p', then m', then v') and with it one autograd version
counter: each is a leaf after ``requires_grad_``, takes index writes, ``cat``
and ``np.save`` as a tensor of its own does, but an in-place write to one of
them while a graph that saved another is still to be differentiated makes
that backward refuse to run. No caller in the port writes an output in place
before the next step.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_KEYS = 8           # csrc/adam.cu kAdamMaxKeys
CHUNK = 4096           # csrc/adam.cu kChunk, checked when the library loads
THREADS = 256          # csrc/adam.cu kThreads, checked likewise

_P, _F, _L, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int


class AdamArgs(ctypes.Structure):
    """The kernel's arguments as ``csrc/adam.cu`` reads them. The step's:
    key k's p, g, m, v pointers at ``inputs[4k:4k + 4]``, the outputs' one
    allocation, each key's ``-lr``, the bias corrections' reciprocals. The
    plan's: each key's length, where its p' starts in ``out`` (its m' and v'
    ``role_stride`` and twice that further), its chunks ``[first_chunk[k],
    first_chunk[k + 1])`` and its element-path elements ``[first_elem[k],
    first_elem[k + 1])``, whether its inputs are on the 16-byte grid; the
    constants; the keys and the blocks."""
    _fields_ = [("inputs", _P * (4 * MAX_KEYS)), ("out", _P),
                ("neg_lr", _F * MAX_KEYS), ("inv_c1", _F), ("inv_c2", _F),
                ("n", _L * MAX_KEYS), ("out_at", _L * MAX_KEYS), ("role_stride", _L),
                ("first_chunk", _L * (MAX_KEYS + 1)), ("first_elem", _L * (MAX_KEYS + 1)),
                ("vec", _I * MAX_KEYS)] + [
        (name, _F) for name in ("b1", "one_minus_b1", "b2", "one_minus_b2", "eps")] + [
        ("keys", _I), ("blocks", _I)]


@functools.lru_cache(maxsize=1)
def _library():
    """The kernel library, once ``AdamArgs`` and the chunk layout are
    checked against the kernel's."""
    lib = build.load_library()
    got = (lib.gs_adam_args_size(), lib.gs_adam_chunk_elems(), lib.gs_adam_threads())
    want = (ctypes.sizeof(AdamArgs), CHUNK, THREADS)
    if got != want:
        raise RuntimeError(f"adam: the kernel's (AdamArgs bytes, chunk, threads) are "
                           f"{got}, the wrapper's {want}")
    return lib


def bias_corrections(count: int) -> Tuple[float, float]:
    """1 - b1^t and 1 - b2^t of the step taken at ``count`` (t = count + 1),
    in float32 as the JAX package's optimizer takes them: 1 - b2^t cancels,
    so its float32 rounding shows in the step."""
    f32 = np.float32
    return (float(f32(1.0) - f32(ADAM_B1) ** f32(count + 1)),
            float(f32(1.0) - f32(ADAM_B2) ** f32(count + 1)))


@functools.lru_cache(maxsize=4096)
def inverse_corrections(count: int) -> Tuple[float, float]:
    """(1 / c1, 1 / c2) of the step taken at ``count``, in double: the
    struct's float fields round them to float32, as torch rounds the
    reciprocal when it divides a CUDA tensor by a Python float."""
    c1, c2 = bias_corrections(count)
    return 1.0 / c1, 1.0 / c2


def adam_update_plain(grads: Dict[str, torch.Tensor], opt_state: dict,
                      lrs: Dict[str, float]) -> Tuple[Dict[str, torch.Tensor], dict]:
    """The plain PyTorch version: (updates to add to the raw tensors, new
    state) of one step at the rates ``lrs`` ({key: rate}, in the keys'
    order), Adam written out on tensors."""
    count = opt_state["count"]
    c1, c2 = bias_corrections(count)
    mu, nu, updates = {}, {}, {}
    for k, lr in lrs.items():
        g = grads[k]
        mu[k] = ADAM_B1 * opt_state["mu"][k] + (1.0 - ADAM_B1) * g
        nu[k] = ADAM_B2 * opt_state["nu"][k] + (1.0 - ADAM_B2) * (g * g)
        step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
        updates[k] = -lr * step
    return updates, {"count": count + 1, "mu": mu, "nu": nu}


def plan_args(lengths: Sequence[int], aligned: Sequence[bool],
              chunk: int = CHUNK) -> AdamArgs:
    """The plan's part of the kernel's arguments for keys of ``lengths``
    elements whose four inputs do (``aligned``) or do not all start on the
    16-byte grid. An aligned key's first n - n % 4 elements go in chunks
    of ``chunk`` (a block each, 16-byte accesses; its last chunk short),
    its last n % 4 to the element path; a key off the grid goes to the
    element path whole (a thread an element, blocks after the chunks).
    Each key's outputs start 16-byte aligned in the one allocation. (A
    probe variant built with another chunk passes its own.)"""
    if not 1 <= len(lengths) <= MAX_KEYS:
        raise ValueError(f"adam: {len(lengths)} keys; the kernel takes 1 to {MAX_KEYS}")
    a = AdamArgs(b1=ADAM_B1, one_minus_b1=1.0 - ADAM_B1, b2=ADAM_B2,
                 one_minus_b2=1.0 - ADAM_B2, eps=ADAM_EPS, keys=len(lengths))
    at = chunks = elements = 0
    for k, (n, ok) in enumerate(zip(lengths, aligned)):
        a.n[k], a.out_at[k], a.vec[k] = n, at, int(ok)
        a.first_chunk[k], a.first_elem[k] = chunks, elements
        at += -(-n // 4) * 4
        vec_n = n & ~3 if ok else 0
        chunks += -(-vec_n // chunk)
        elements += n - vec_n
    for k in range(len(lengths), MAX_KEYS + 1):
        a.first_chunk[k], a.first_elem[k] = chunks, elements
    a.role_stride = at
    a.blocks = chunks + -(-elements // THREADS)
    return a


def _key_of(first, x: int) -> int:
    """``csrc/adam.cu`` key_of: the last key whose first entry is at or
    before x."""
    k = 0
    for i in range(1, MAX_KEYS):
        if x >= first[i]:
            k = i
    return k


def plan_work(a: AdamArgs) -> List[Tuple[int, int, int, str]]:
    """The work the kernel does by the plan in ``a``, read from the struct
    as ``csrc/adam.cu`` reads it: (key, first element, end, "chunk") for
    each chunk's block in block order, then
    (key, first element, end, "element") for each key's run of the element
    index space (the kernel's key lookup taken at the run's two ends)."""
    work = []
    for c in range(a.first_chunk[MAX_KEYS]):
        k = _key_of(a.first_chunk, c)
        start = (c - a.first_chunk[k]) * CHUNK
        work.append((k, start, min(start + CHUNK, a.n[k] & ~3), "chunk"))
    for k in range(MAX_KEYS):
        lo_x, hi_x = a.first_elem[k], a.first_elem[k + 1]
        if lo_x < hi_x:
            assert _key_of(a.first_elem, lo_x) == _key_of(a.first_elem, hi_x - 1) == k
            lo = a.n[k] & ~3 if a.vec[k] else 0
            work.append((k, lo, lo + hi_x - lo_x, "element"))
    return work


def step_args(a: AdamArgs, ptrs: Sequence[int], out: int, lrs: Dict[str, float],
              count: int) -> AdamArgs:
    """Write one step's part of the arguments into ``a``: the inputs'
    pointers (key-major: p, g, m, v of each key of ``lrs`` in its order),
    the outputs' allocation, each key's -lr and the reciprocals of the step
    at ``count``. Each Python scalar is rounded to float32 as torch rounds
    it; the bias corrections divide as torch divides a CUDA tensor by a
    Python float, by a product with the reciprocal taken in double and
    rounded to float32."""
    a.inputs[:len(ptrs)] = ptrs
    a.out = out
    a.neg_lr[:len(lrs)] = [-lr for lr in lrs.values()]
    a.inv_c1, a.inv_c2 = inverse_corrections(count)
    return a


class Plan:
    """A cached launch: the struct (plan filled, step rewritten each call),
    its address, the outputs' allocation length, the keys and the views
    ((shape, stride, offset) of every key's p', then m', then v')."""
    __slots__ = ("args", "addr", "total", "views", "keys")

    def __init__(self, args: AdamArgs, shapes, keys):
        self.args, self.addr = args, ctypes.addressof(args)
        self.total = 3 * args.role_stride
        self.keys = keys
        self.views = [(s, _contiguous_strides(s), r * args.role_stride + args.out_at[k])
                      for r in range(3) for k, s in enumerate(shapes)]


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, run = [], 1
    for d in reversed(shape):
        strides.append(run)
        run *= d
    return tuple(reversed(strides))


_META = operator.attrgetter("shape", "dtype")
_PTR = torch.Tensor.data_ptr
_DEVICE = torch.Tensor.get_device                  # an int: -1 on the CPU
_CONTIGUOUS = torch.Tensor.is_contiguous
_PLANS: Dict[tuple, object] = {}
MAX_PLANS = 64               # shapes seen (densify at each capacity); then cleared
_CPU = object()              # the plan of CPU inputs: the plain version
_LOCK = threading.Lock()     # a plan's struct is rewritten each call


def misaligned_keys(ptrs: Sequence[int]) -> int:
    """A bit for each key (four key-major pointers a key) with an input off
    the 16-byte grid."""
    if not functools.reduce(operator.or_, ptrs, 0) & 15:
        return 0
    return sum(1 << k for k in range(len(ptrs) // 4)
               if (ptrs[4 * k] | ptrs[4 * k + 1] | ptrs[4 * k + 2] | ptrs[4 * k + 3]) & 15)


def _new_plan(key, ins: List[torch.Tensor]):
    """The plan of inputs ``ins`` (key-major p, g, m, v) under ``key``
    (keys, shapes and dtypes, devices, contiguity, misaligned keys), after
    the checks the kernel needs; ``_CPU`` where every input lies on the
    CPU."""
    keys, meta, devices, _, misaligned = key
    if max(devices) < 0:
        return _CPU
    if len(set(devices)) != 1:
        raise ValueError(f"adam: inputs must all lie on the CPU or all on one CUDA device, "
                         f"got {sorted({str(t.device) for t in ins})}")
    for i, k in enumerate(keys):
        g_shape = meta[4 * i + 1][0]
        for name, (shape, dtype) in zip(("raw", "grad", "mu", "nu"), meta[4 * i:4 * i + 4]):
            if dtype != torch.float32 or shape != g_shape:
                raise ValueError(f"adam: {name}[{k!r}] is {dtype} {tuple(shape)}, "
                                 f"the gradient float32 {tuple(g_shape)}")
    shapes = [meta[4 * i + 1][0] for i in range(len(keys))]
    args = plan_args([ins[4 * i + 1].numel() for i in range(len(keys))],
                     [not misaligned >> i & 1 for i in range(len(keys))])
    return Plan(args, shapes, keys)


def plan(grads: Dict[str, torch.Tensor], opt_state: dict, lrs: Dict[str, float],
         raw: Dict[str, torch.Tensor]):
    """(the cached plan of these inputs: ``_CPU`` for CPU inputs, None for
    CUDA inputs that are not all contiguous; the inputs, key-major p, g, m,
    v; their pointers)."""
    mu, nu = opt_state["mu"], opt_state["nu"]
    ins = [d[k] for k in lrs for d in (raw, grads, mu, nu)]
    ptrs = list(map(_PTR, ins))
    key = (tuple(lrs), tuple(map(_META, ins)), tuple(map(_DEVICE, ins)),
           all(map(_CONTIGUOUS, ins)), misaligned_keys(ptrs))
    got = _PLANS.get(key)
    if got is None:
        if not key[3] and max(key[2]) >= 0:
            return None, ins, ptrs
        if len(_PLANS) >= MAX_PLANS:
            _PLANS.clear()
        got = _PLANS[key] = _new_plan(key, ins)
    return got, ins, ptrs


def adam_update(grads: Dict[str, torch.Tensor], opt_state: dict, lrs: Dict[str, float],
                raw: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One step of every key of ``lrs`` ({key: rate}): (raw + updates, new
    state). On CPU tensors the plain version and the addition; on CUDA
    tensors one launch of the kernel, which raises where it cannot run
    (inputs that are not contiguous are copied first)."""
    p, ins, ptrs = plan(grads, opt_state, lrs, raw)
    if p is _CPU:
        updates, state = adam_update_plain(grads, opt_state, lrs)
        return {k: raw[k] + updates[k] for k in lrs}, state
    if p is None:
        def dense(d):
            return {k: d[k].contiguous() for k in lrs}
        return adam_update(dense(grads), dict(opt_state, mu=dense(opt_state["mu"]),
                                              nu=dense(opt_state["nu"])), lrs, dense(raw))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "adam: this CUDA kernel has no backward; call it under torch.no_grad() or on "
            "tensors that do not require grad")
    lib = _library()
    count = opt_state["count"]
    buf = ins[1].new_empty(p.total)          # float32 on the inputs' device, as planned
    with _LOCK:
        step_args(p.args, ptrs, buf.data_ptr(), lrs, count)
        build.check("adam", lib.gs_adam_step(p.addr, build.stream_ptr()))
    adam_update.launches += 1
    outs = [buf.as_strided(*v) for v in p.views]
    n = len(p.keys)
    return (dict(zip(p.keys, outs[:n])),
            {"count": count + 1, "mu": dict(zip(p.keys, outs[n:2 * n])),
             "nu": dict(zip(p.keys, outs[2 * n:]))})


adam_update.launches = 0
