"""One Adam step over every raw tensor of a train step.

The JAX package takes it with optax's ``adam`` (``train/trainer.py``
``make_optimizer``), which XLA fuses; no Pallas kernel. The kernel is
``csrc/adam.cu``: one launch for all keys (multi-tensor apply), each
element's p, g, m and v read once and p', m' and v' written once, every
float rounded as ``adam_update_plain``'s torch calls round on the card, so
the two are bit-equal there. The step is functional: p', m' and v' are new
tensors, and the state passed in is not written.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_KEYS = 8           # csrc/adam.cu kAdamMaxKeys

_P = ctypes.c_void_p


class AdamArgs(ctypes.Structure):
    """The step's pointers and scalars as ``csrc/adam.cu`` reads them;
    ``first_block`` and ``vec`` are filled by the C entry point."""
    _fields_ = [(name, _P * MAX_KEYS) for name in (
        "p", "g", "m", "v", "p_out", "m_out", "v_out")] + [
        ("n", ctypes.c_longlong * MAX_KEYS),
        ("first_block", ctypes.c_longlong * (MAX_KEYS + 1)),
        ("neg_lr", ctypes.c_float * MAX_KEYS),
        ("vec", ctypes.c_int * MAX_KEYS)] + [
        (name, ctypes.c_float) for name in (
            "b1", "one_minus_b1", "b2", "one_minus_b2", "inv_c1", "inv_c2", "eps")] + [
        ("keys", ctypes.c_int)]


@functools.lru_cache(maxsize=1)
def _library():
    """The kernel library, once ``AdamArgs`` is checked against the
    kernel's layout."""
    lib = build.load_library()
    if lib.gs_adam_args_size() != ctypes.sizeof(AdamArgs):
        raise RuntimeError(f"adam: the kernel's AdamArgs has {lib.gs_adam_args_size()} "
                           f"bytes, AdamArgs {ctypes.sizeof(AdamArgs)}")
    return lib


def bias_corrections(count: int) -> Tuple[float, float]:
    """1 - b1^t and 1 - b2^t of the step taken at ``count`` (t = count + 1),
    in float32 as the JAX package's optimizer takes them: 1 - b2^t cancels,
    so its float32 rounding shows in the step."""
    f32 = np.float32
    return (float(f32(1.0) - f32(ADAM_B1) ** f32(count + 1)),
            float(f32(1.0) - f32(ADAM_B2) ** f32(count + 1)))


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


def adam_args(tensors, lrs: Dict[str, float], count: int) -> AdamArgs:
    """The kernel's arguments: ``tensors`` = {key: (p, g, m, v, p', m',
    v')}, all float32 of one length a key. Each Python scalar is rounded
    to float32 as torch rounds it; the bias corrections divide as torch
    divides a CUDA tensor by a Python float, by a product with the
    reciprocal taken in double and rounded to float32."""
    if not 1 <= len(lrs) <= MAX_KEYS:
        raise ValueError(f"adam: {len(lrs)} keys; the kernel takes 1 to {MAX_KEYS}")
    c1, c2 = bias_corrections(count)
    a = AdamArgs(b1=ADAM_B1, one_minus_b1=1.0 - ADAM_B1, b2=ADAM_B2,
                 one_minus_b2=1.0 - ADAM_B2, inv_c1=1.0 / c1, inv_c2=1.0 / c2,
                 eps=ADAM_EPS, keys=len(lrs))
    for i, (k, lr) in enumerate(lrs.items()):
        ts = tensors[k]
        for name, t in zip(("p", "g", "m", "v", "p_out", "m_out", "v_out"), ts):
            getattr(a, name)[i] = t.data_ptr()
        a.n[i] = ts[1].numel()
        a.neg_lr[i] = -lr
    return a


def adam_update(grads: Dict[str, torch.Tensor], opt_state: dict, lrs: Dict[str, float],
                raw: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One step of every key of ``lrs`` ({key: rate}): (raw + updates, new
    state). On CPU tensors the plain version and the addition; on CUDA
    tensors one launch of the kernel, which raises where it cannot run."""
    keys = list(lrs)
    m_in, v_in = opt_state["mu"], opt_state["nu"]
    every = [t[k] for t in (grads, m_in, v_in, raw) for k in keys]
    if not build.on_cuda("adam", *every):
        updates, state = adam_update_plain(grads, opt_state, lrs)
        return {k: raw[k] + updates[k] for k in keys}, state
    tensors, out, mu, nu = {}, {}, {}, {}
    for k in keys:
        g = grads[k].contiguous()
        ins = [raw[k].contiguous(), g, m_in[k].contiguous(), v_in[k].contiguous()]
        for name, t in zip(("raw", "grad", "mu", "nu"), ins):
            if t.dtype != torch.float32 or t.shape != g.shape:
                raise ValueError(f"adam: {name}[{k!r}] is {t.dtype} {tuple(t.shape)}, "
                                 f"the gradient float32 {tuple(g.shape)}")
        out[k], mu[k], nu[k] = (torch.empty_like(g) for _ in range(3))
        tensors[k] = (*ins, out[k], mu[k], nu[k])
    args = adam_args(tensors, lrs, opt_state["count"])
    lib = _library()
    build.check("adam", lib.gs_adam_step(ctypes.addressof(args), build.stream_ptr()))
    adam_update.launches += 1
    return out, {"count": opt_state["count"] + 1, "mu": mu, "nu": nu}


adam_update.launches = 0
