#!/usr/bin/env python3
"""The port's onesweep radix sort against ``torch.sort``: a whole sort of
one u32 key and 9 f32 payload rows, the record sort's operand shape.

The port's counterpart of ``scripts/radix_sort_bench.py``. For each size C
(``--sizes``, default as the JAX script's ``RADIX_SIZES``):

- ``lax_ms``: ``torch.sort(stable=True)`` of the key plus a gather of the 9
  rows, the counterpart of the JAX script's ``lax.sort`` of the key and
  its payloads;
- ``radix31_ms``: ``ops/kernels/radix_sort.radix_sort`` of keys below 2^31
  (``key_bits=31``, four 8-bit passes), the packed (tile, depth) key;
- ``radix9_ms``: keys below 512 (``key_bits=9``, two passes), the tile
  ids of the hoisted mode;
- ``*_exact``: the sorted keys and every payload row equal to the
  ``torch.sort`` reference's, element for element.

Keys are ``numpy default_rng(0)`` draws, held as int32 bit patterns of u32
as the port stores them. Times: ``ITERS`` sorts a run, median of
``REPEATS`` runs (CUDA events on the card). One JSON line a size, then
``{"radix_bench": [...]}`` with ``device`` and ``card`` as the last line.

    python3 scripts/torch_radix_sort_bench.py                # the card
    python3 scripts/torch_radix_sort_bench.py --sizes 6291456
    python3 scripts/torch_radix_sort_bench.py --device cpu --sizes 4096,10000

``main(argv)`` runs it in-process and returns the last JSON object.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NPAYLOAD = 9
ITERS = 5
REPEATS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", default=os.environ.get(
        "RADIX_SIZES", "524288,1048576,2097152"),
        help="comma-separated key counts")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="sort on the CUDA card (default) or on the CPU")
    args = ap.parse_args(argv)
    args.sizes = [int(s) for s in args.sizes.split(",")]
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels.radix_sort import radix_sort
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        median_ms,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    log(f"device: {dev} ({card})")

    def reference(keys, vals):
        """The stable torch.sort of the keys and the gather of the rows."""
        sk, idx = torch.sort(keys, stable=True)
        return sk, vals[:, idx]

    rng = np.random.default_rng(0)
    results = []
    for c in args.sizes:
        keys31 = torch.as_tensor(rng.integers(0, 1 << 31, c, dtype=np.uint32)
                                 .view(np.int32), device=dev)
        keys9 = torch.as_tensor(rng.integers(0, 512, c, dtype=np.uint32)
                                .view(np.int32), device=dev)
        vals = torch.as_tensor(np.stack([rng.standard_normal(c).astype(np.float32)
                                         for _ in range(NPAYLOAD)]), device=dev)
        rows = tuple(vals)

        ms_ref, _ = median_ms(lambda: reference(keys31, vals), dev, ITERS, REPEATS)
        log(f"C={c}: torch.sort + gather {ms_ref:.3f} ms")
        row = {"C": c, "lax_ms": ms_ref}
        for name, keys, kb in (("radix31", keys31, 31), ("radix9", keys9, 9)):
            ms, (sk, sv) = median_ms(lambda: radix_sort(keys, rows, key_bits=kb),
                                     dev, ITERS, REPEATS)
            rk, rv = reference(keys, vals)
            ok = bool(torch.equal(sk, rk)) and all(
                torch.equal(a, b) for a, b in zip(sv, rv))
            row[f"{name}_ms"] = ms
            row[f"{name}_exact"] = ok
            log(f"C={c}: {name} {ms:.3f} ms exact={ok}")
        results.append(row)
        print(json.dumps(row), flush=True)
    out = {"radix_bench": results, "device": str(dev), "card": card}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
