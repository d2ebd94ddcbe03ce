#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, many seeds in one
process (not run by the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --mode <mode> [--seconds 1]

Modes:

- ``program``: the cell as ``run.py`` runs it (a short window), its
  compared numbers on each seed: the lower readings;
- ``q16``, ``bwd_bf16``: the program with its own lower-precision path
  switched on (``faults.CONTROLS``): the control where the program has one;
- ``ref_bf16``: the reference in bfloat16 put in the program's place,
  against the reference in float32, at the cell's size and poses or views:
  the control where the program has no such path;
- ``unchanged``, ``half_batch``, ``altered``: the program with a fault
  planted (``faults.FAULTS``).

Prints one JSON line a seed, then the largest and the smallest reading of
each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def ref_bf16(args, device, base=HERE, man=None):
    """The reference in bfloat16 against the reference in float32, on the
    poses the cell would sample or the views it would check."""
    import random

    import torch

    from benchmark import check, manifest, scenes
    from benchmark.reference import render as rr
    from benchmark.reference import train as rt

    man = man if man is not None else manifest.load()
    wl = manifest.workload(man, args.workload)
    cfg, mix = manifest.config(wl["config"], base), manifest.mix(wl["traffic"], base)
    low = rr.Precision(torch.bfloat16)
    fr = rr.frame_of(cfg)
    if mix["kind"] == "orbit":
        params = scenes.activated(scenes.raw_scene(cfg, args.seed, device))
        poses = int(mix["poses"])
        cams = scenes.orbit(cfg, mix, args.seed % poses)
        sample = random.Random(args.seed).sample(range(int(mix["sample_span"])),
                                                 int(mix["sample_frames"]))
        pairs = []
        for i in sorted(sample):
            img, n = rr.render(params, cams[i % poses], fr, low)
            ref, total = rr.render(params, cams[i % poses], fr)
            pairs.append((img, n, ref, total))
        return check.frame_numbers(pairs)
    raw0 = scenes.raw_scene(cfg, args.seed, device)
    views = scenes.training_views(cfg)
    rng, stack, chosen = random.Random(args.seed), [], []
    for _ in range(int(mix["checked_steps"])):
        if not stack:
            stack = list(range(len(views)))
            rng.shuffle(stack)
        chosen.append(stack.pop())
    tg = scenes.targets(cfg, len(views), args.seed, device)
    kept = [(tg[v].clone(), views[v]) for v in chosen]
    del tg
    lo = rt.run_steps(raw0, kept, cfg, len(kept), low)
    hi = rt.run_steps(raw0, kept, cfg, len(kept))
    norms = lambda d: {k: check.norm(v) for k, v in d.items()}  # noqa: E731
    return check.step_numbers(lo[0], norms(lo[1]), norms(lo[2]), hi[0], norms(hi[1]),
                              norms(hi[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    import torch

    from benchmark import faults, run, sut

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    readings = []
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
        t0 = time.perf_counter()
        if a.mode == "ref_bf16":
            numbers = ref_bf16(args, dev)
        else:
            program = sut if a.mode == "program" else faults.Faulty(sut, a.mode)
            run.T0 = time.perf_counter()
            res, compared = run.run_cell(args, dev, program=program)
            numbers = {k: v for k, (v, _) in compared.items()}
            numbers["failed"] = res["failed"]
        readings.append(numbers)
        print(json.dumps({"workload": a.workload, "mode": a.mode, "seed": seed,
                          "seconds": time.perf_counter() - t0, **numbers}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    keys = readings[0].keys()
    print(json.dumps({"mode": a.mode, "max": {k: max(r[k] for r in readings) for k in keys},
                      "min": {k: min(r[k] for r in readings) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
