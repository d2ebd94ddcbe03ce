"""Parameter dicts between numpy and torch.

The JAX package passes splat parameters as a dict of arrays (``means``
(N, 3), ``scales`` (N, 3), ``quats`` (N, 4) wxyz, ``opacities`` (N,),
``colors`` (N, 3), optionally ``cov6`` (N, 6), ``sh_rest`` (N, 45) and
``shift2d`` (N, 2)).
The port takes the same dict with float32 tensors; ``params_from_numpy``
and ``params_to_numpy`` carry a dict across, so both packages can be fed
identical inputs. ``raw_from_numpy`` / ``raw_to_numpy`` do the same for the
trainer's raw (pre-activation) dict, and ``train_state_from_checkpoint``
turns a checkpoint written by the JAX trainer into the port's
``TrainState``, so both packages can continue from the same state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

RAW_KEYS = ("means", "log_scales", "quats", "logit_opacities", "colors",
            "sh_rest")
PARAM_KEYS = ("means", "scales", "quats", "opacities", "colors", "cov6",
              "sh_rest", "shift2d")


def params_from_numpy(d: Dict[str, np.ndarray],
                      device: torch.device | str) -> Dict[str, torch.Tensor]:
    """numpy parameter dict -> float32 tensors on ``device``.

    Unknown keys raise, so a typo cannot silently drop a parameter."""
    unknown = set(d) - set(PARAM_KEYS)
    if unknown:
        raise KeyError(f"unknown parameter keys {sorted(unknown)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in d.items()}


def params_to_numpy(p: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``: float32 numpy arrays on the host."""
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in p.items()}


def raw_from_numpy(d: Dict[str, np.ndarray],
                   device: torch.device | str) -> Dict[str, torch.Tensor]:
    """numpy raw (pre-activation) dict -> float32 tensors on ``device``."""
    unknown = set(d) - set(RAW_KEYS)
    if unknown:
        raise KeyError(f"unknown raw parameter keys {sorted(unknown)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in d.items()}


raw_to_numpy = params_to_numpy


def train_state_from_checkpoint(ckpt, tc, device: torch.device | str):
    """A checkpoint of the JAX trainer -> the port's ``TrainState``.

    ``ckpt`` is the path of an npz written by the JAX package's
    ``save_checkpoint`` or a mapping with its arrays: the raw tensors,
    ``step``, and the optimizer leaves ``o_<i>`` in
    ``jax.tree_util.tree_leaves`` order of its ``optax.multi_transform``
    state. That order is, for each raw key in sorted order: Adam's count,
    ``mu[key]``, ``nu[key]`` and, for ``means`` when ``tc`` has a position
    schedule (``lr_means_final``), the schedule's own count. ``tc`` is the
    ``TrainConfig`` the checkpoint was trained with (either package's).
    """
    from openglgaussiansplattingrenderer_tpu_torch.train import trainer

    raw, step, extras = (trainer.load_checkpoint_full(ckpt) if isinstance(ckpt, str)
                         else trainer.split_checkpoint(dict(ckpt)))
    raw = raw_from_numpy(raw, device)
    leaves = extras.get("opt_leaves", [])
    keys = sorted(raw)
    scheduled = tc.lr_means_final is not None
    want = 3 * len(keys) + (1 if scheduled and "means" in raw else 0)
    if len(leaves) != want:
        raise ValueError(
            f"checkpoint has {len(leaves)} optimizer leaves, the parameter "
            f"set {keys} with this TrainConfig wants {want}")
    it = iter(leaves)
    counts, mu, nu = set(), {}, {}
    for k in keys:
        counts.add(int(next(it)))
        for moments in (mu, nu):
            m = np.asarray(next(it), dtype=np.float32)
            if m.shape != tuple(raw[k].shape):
                raise ValueError(f"optimizer moment of {k!r} has shape "
                                 f"{m.shape}, the tensor {tuple(raw[k].shape)}")
            moments[k] = torch.as_tensor(m).to(device)
        if k == "means" and scheduled:
            counts.add(int(next(it)))
    if len(counts) != 1:
        raise ValueError(f"optimizer step counts disagree: {sorted(counts)}")
    return trainer.TrainState(raw, {"count": counts.pop(), "mu": mu, "nu": nu},
                              step)
