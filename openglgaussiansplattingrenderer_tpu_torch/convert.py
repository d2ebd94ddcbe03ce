"""Parameter dicts between numpy and torch.

The JAX package passes splat parameters as a dict of arrays (``means``
(N, 3), ``scales`` (N, 3), ``quats`` (N, 4) wxyz, ``opacities`` (N,),
``colors`` (N, 3), optionally ``cov6`` (N, 6), ``sh_rest`` (N, 45) and
``shift2d`` (N, 2)).
The port takes the same dict with float32 tensors; these two functions
carry a dict across, so both packages can be fed identical inputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PARAM_KEYS = ("means", "scales", "quats", "opacities", "colors", "cov6",
              "sh_rest", "shift2d")


def params_from_numpy(d: Dict[str, np.ndarray],
                      device: torch.device | str) -> Dict[str, torch.Tensor]:
    """numpy parameter dict -> float32 tensors on ``device``.

    Unknown keys raise, so a typo cannot silently drop a parameter."""
    unknown = set(d) - set(PARAM_KEYS)
    if unknown:
        raise KeyError(f"unknown parameter keys {sorted(unknown)}")
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32)).to(device)
            for k, v in d.items()}


def params_to_numpy(p: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``: float32 numpy arrays on the host."""
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in p.items()}
