"""What one level of a bucketing record sort costs on the card, at least.

Counterpart of ``scripts/bucketer_probe.py``; the kernel is
``csrc/bucketer_probe.cu``. Any level that stably distributes a chunk of
``R`` records into ``K`` buckets must, per chunk, find each record's
bucket and its rank among the chunk's records of that bucket, compact the
record's 16 field rows to that rank, and flush the buckets' sub-blocks to
device memory. ``bucketer_level`` does exactly those, with no bookkeeping
(no fill carried between chunks, no overflow handling: only the first
``CARRY`` records of a bucket are flushed), so its time bounds a real
level from below. A full sort needs two or more levels at K of 16 to 64.

Every chunk flushes to a slab of its own, (n_chunks, 16, K * CARRY): GPU
blocks run in no order, so the one shared region the TPU probe overwrites
chunk after chunk would be a race. The bytes written are the same, and the
TPU probe's output is the last chunk's slab.

    python3 -m openglgaussiansplattingrenderer_tpu_torch.probes.bucketer_probe

prints ``{"bucketer_level_lower_bound_ms": ..., "C": ..., "K": ..., "R":
...}`` beside the card's name; ``BUCKET_C`` and ``BUCKET_K`` set the
record count and the bucket count.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

C = 6 * 1024 * 1024    # records: the flagship frame's capacity
R = 512                # records a chunk: kR of csrc/bucketer_probe.cu
K = 32                 # buckets this level
ROWS = 16              # field rows a record
TILE_ROW = 9           # the row that holds the tile id, in [0, 512)
CARRY = 128            # slots flushed a bucket
MAX_K = 64


def bucketer_level_plain(rec: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version of ``bucketer_level``: bucket by bucket, a
    prefix sum of the bucket's mask along the chunk is the rank, as the TPU
    kernel takes it."""
    n_chunks = rec.shape[1] // R
    rec = rec[:, :n_chunks * R]
    bucket = torch.floor(rec[TILE_ROW] * (k / 512.0)).view(n_chunks, R)
    out = rec.new_zeros((n_chunks, ROWS, k * CARRY))
    for b in range(k):
        mask = bucket == float(b)
        rank = torch.cumsum(mask, 1) - 1
        chunk, at = torch.nonzero(mask & (rank < CARRY), as_tuple=True)
        out[chunk, :, b * CARRY + rank[chunk, at]] = rec[:, chunk * R + at].t()
    return out


def bucketer_level(rec: torch.Tensor, k: int = K) -> torch.Tensor:
    """One bucketing level over ``rec`` (16, C) float32, whose row 9 holds
    tile ids in [0, 512): for each chunk of 512 records and each bucket b =
    floor(tile * k / 512), the chunk's first 128 records of the bucket, in
    input order, all 16 rows, at ``out[chunk, :, b * 128 + rank]``; slots
    past the bucket's count are zero. Columns past the last whole chunk are
    ignored. Returns (C // 512, 16, k * 128) float32."""
    build.expect("bucketer_level rec", rec, torch.float32, (ROWS, None))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"bucketer_level: k must be in [1, {MAX_K}], got {k}")
    if not build.on_cuda("bucketer_level", rec):
        return bucketer_level_plain(rec, k)
    c = rec.shape[1]
    out = torch.empty((c // R, ROWS, k * CARRY), dtype=torch.float32,
                      device=rec.device)
    if c < R:
        return out
    lib = build.load_library()
    if lib.gs_bucketer_chunk() != R:
        raise RuntimeError("bucketer_level: the library's chunk differs from R")
    build.check("bucketer_level", lib.gs_bucketer_level(
        rec.data_ptr(), c, k, k / 512.0, out.data_ptr(), build.stream_ptr()))
    bucketer_level.launches += 1
    return out


bucketer_level.launches = 0


def make_records(c: int, device, seed: int = 0) -> torch.Tensor:
    """(16, c) normal field rows with uniform tile ids in row 9, made on
    ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rec = torch.randn((ROWS, c), generator=gen, device=device)
    rec[TILE_ROW] = torch.randint(0, 512, (c,), generator=gen,
                                  device=device).to(torch.float32)
    return rec


def run(c: int = C, k: int = K, reps: int = 5) -> dict:
    """Time ``bucketer_level`` on the card at ``c`` records and ``k``
    buckets (CUDA events, median of ``reps`` after two warm-up launches)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bucketer_probe measures on an NVIDIA GPU; none found")
    rec = make_records(c, torch.device("cuda"))
    times = []
    for it in range(reps + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = bucketer_level(rec, k)
        end.record()
        end.synchronize()
        if it >= 2:
            times.append(start.elapsed_time(end))
    assert out.shape == (c // R, ROWS, k * CARRY)
    return {"bucketer_level_lower_bound_ms": statistics.median(times),
            "C": c, "K": k, "R": R, "device": torch.cuda.get_device_name(0)}


def main() -> int:
    print(json.dumps(run(int(os.environ.get("BUCKET_C", str(C))),
                         int(os.environ.get("BUCKET_K", str(K))))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
