#!/usr/bin/env python3
"""Multi-device scaling report of the port's sharded frame.

The port's counterpart of ``scripts/scaling_report.py``. From the real
record distribution of one single-device frame (the (tile, depth) bounds
of ``fastpath.sort_records``, kernels 1 and 2 on the card) it reports, for
D shards under round-robin tile ownership (owner = tile % D, as
``parallel/fast_sharded.py`` assigns tiles):

- records per owner, and the composite pair work per owner, records times
  tile pixels, quantised to whole ``chunk`` batches;
- the exchange volume, binned records x (1 - 1/D) x 44 B (9 fields, tile
  and depth in f32), and its time at the link rate, each card sending its
  share over its own link;
- a load-balance efficiency bound, mean over largest owner's pair work;
- a cross-check: ``render_fast_sharded`` on a D-shard mesh must exchange
  exactly the binned records (``stats["exchanged_records"]``).

The link rate: with two or more cards, a peer copy of one bucket block of
the flagship's exchange at four shards (6,291,456 rows x 44 B) from
``cuda:0`` to ``cuda:1`` is timed, and ``nvidia-smi topo -m``'s link
between the two is printed. With one card the rate is
``--link-gbps``, whose default comes from the four-card run of the sharded
frame recorded in PERF.md (PR 10): 9.2 ms of peer copies on the device,
summed over the cards, for the blocks the exchange moved between cards,
12 blocks of 6,291,456 bucket rows x 44 B (the uniform flagship padded to
3,616,104 rows, ``exchange_capacity`` at exch_factor 4, every bucket block
but a card's own crossing a link).

Then the flagship (3,616,103 splats at 1024x512) at 1, 2, 4 and 8 shards:
the same counts, and a frame bound, the single-device frame (CUDA events,
median of 5) times the busiest owner's share of the pair work plus the
exchange time, as fps beside the four-card frame of PR 10 and, where the
host has that many cards, the sharded frame measured on them.

    python3 scripts/torch_scaling_report.py                 # on the card
    python3 scripts/torch_scaling_report.py --device cpu --splats 2000 \\
        --width 128 --height 96 --devices 4 --flagship-splats 2000

Prints the report and, last, one JSON line (``--json``: the JSON line
alone). Writes no file. ``main(argv)`` returns the report. On the CPU no
time is measured: those fields read None.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import padded_dims  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded as sh  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.render import (  # noqa: E402
    autotune_capacity,
    camera_args,
    render_arrays,
)

REC_BYTES = 11 * 4                  # 9 fields + tile + depth, f32
FLAG_SPLATS, FLAG_W, FLAG_H = 3_616_103, 1024, 512
FLAG_SHARDS = (1, 2, 4, 8)
# The sharded uniform flagship frame on four H100 cards (PERF.md, PR 10,
# chip_smoke.py phase [9] under --cards 4, three runs) and the peer copies
# on the device in one such frame: the bytes are the 12 off-card blocks of
# 6,291,456 bucket rows the exchange moved (exchange_capacity at exch
# factor 4 for 904,026 splats a shard at the frame's autotuned capacity).
PR10_FOUR_CARD_FRAME_MS = (51.910, 52.497, 54.154)
PR10_PEER_COPY_MS = 9.2
PR10_BLOCK_BYTES = 6_291_456 * REC_BYTES
PR10_PEER_BYTES = 4 * 3 * PR10_BLOCK_BYTES
PR10_LINK_GBPS = PR10_PEER_BYTES / (PR10_PEER_COPY_MS * 1e-3) / 1e9


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def frame_of(n_splats, seed, width, height, chunk, dup, log_scale_range, device):
    """(params, camera args (view, vp, fx, fy, tfx, tfy), cfg with its
    capacity tuned to the frame) of a uniform synthetic scene seen from
    (0, 0, -8)."""
    cfg = RenderConfig.for_resolution(width, height, tile_px=32, use_pallas=True,
                                      chunk=chunk, dup_capacity_factor=dup)
    scene = ply_io.make_synthetic_scene(n_splats, seed=seed, extent=3.0,
                                        log_scale_range=log_scale_range)
    params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"}, device)
    a = camera_args(Camera(0.0, 0.0, -8.0, width=width, height=height))
    args = (torch.as_tensor(a["view"], device=device), torch.as_tensor(a["vp"], device=device),
            a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])
    return params, args, autotune_capacity(params, *args, width, height, cfg)


def tile_bounds(params, args, width, height, cfg) -> np.ndarray:
    """(T + 1,) record bounds of the frame's (tile, depth)-sorted records."""
    with torch.no_grad():
        rec = fastpath.expand_depth_records(params, *args, width, height, cfg,
                                            key=fastpath.record_key(cfg))
        _, bounds = fastpath.sort_records(*rec, width, height, cfg)
    return bounds.cpu().numpy().astype(np.int64)


def distribution(bounds: np.ndarray, ndev: int, width: int, height: int,
                 cfg: RenderConfig, link_gbps: float) -> dict:
    """Per-owner records and pair work, imbalances, the efficiency bound and
    the exchange volume of D = ``ndev`` shards."""
    counts = np.diff(bounds)
    binned = int(bounds[-1])
    records = np.array([counts[d::ndev].sum() for d in range(ndev)], np.int64)
    starts = (bounds[:-1] // cfg.chunk) * cfg.chunk
    nch = np.maximum(-(-(bounds[1:] - starts) // cfg.chunk), 0) * (counts > 0)
    wp, hp = padded_dims(width, height, cfg)
    px = (wp // cfg.grid_x) * (hp // cfg.grid_y)
    pair_work = nch * cfg.chunk * px
    pairs = np.array([pair_work[d::ndev].sum() for d in range(ndev)], np.int64)

    def imbalance(x):
        return float(x.max() / max(x.mean(), 1e-9))

    moved = binned * (1 - 1 / ndev) * REC_BYTES
    return {"devices": ndev, "binned_records": binned,
            "per_owner_records": records.tolist(), "per_owner_pair_work": pairs.tolist(),
            "records_imbalance": imbalance(records), "pairs_imbalance": imbalance(pairs),
            "efficiency_bound": 1.0 / imbalance(pairs), "exchange_bytes": moved,
            "exchange_ms": moved / ndev / (link_gbps * 1e9) * 1e3}


def frame_ms(fn) -> float:
    """Median wall time of ``fn`` in ms, every card synchronised (5 runs
    after 2 warm-up calls)."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(2):
        fn()
    sync()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_of(ndev: int, device: torch.device):
    """D shards: distinct cards where the host has them, else the one
    device repeated. Returns (mesh, what it runs on)."""
    if device.type == "cuda" and torch.cuda.device_count() >= ndev:
        return sh.make_mesh(ndev), f"{ndev} cards"
    return sh.make_mesh(devices=[device] * ndev), f"{ndev} shards on {device}"


def topo_link(a: int, b: int) -> str:
    """The link between cards a and b in ``nvidia-smi topo -m``'s matrix
    (its headers come underlined by terminal escapes), or why it was not
    read."""
    try:
        done = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
    rows = [ln.split() for ln in re.sub(r"\x1b\[[0-9;]*m", "", done.stdout).splitlines()]
    head = next((r for r in rows if f"GPU{b}" in r and "X" not in r), None)
    row = next((r for r in rows if r[:1] == [f"GPU{a}"] and "X" in r), None)
    if done.returncode or head is None or row is None:
        why = (done.stderr or done.stdout).strip().splitlines()[:1]
        return f"not read (exit {done.returncode}: {why[0] if why else 'no matrix'})"
    return row[1 + head.index(f"GPU{b}")]


def link_rate(nbytes: int, device: torch.device, default_gbps: float) -> dict:
    """The link rate in GB/s: a timed peer copy of ``nbytes`` between
    ``cuda:0`` and ``cuda:1`` where two cards exist, else the default."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return {"gbps": default_gbps, "measured": False,
                "source": (f"--link-gbps (default: PERF.md PR 10's four-card sharded "
                           f"frame, {PR10_PEER_COPY_MS} ms of peer copies for "
                           f"{PR10_PEER_BYTES} bytes moved between cards)")}
    src = torch.empty(int(nbytes), dtype=torch.uint8, device="cuda:0")
    dst = torch.empty_like(src, device="cuda:1")
    ms = frame_ms(lambda: dst.copy_(src))
    return {"gbps": nbytes / (ms * 1e-3) / 1e9, "measured": True, "copy_ms": ms,
            "copy_bytes": int(nbytes), "topo_gpu0_gpu1": topo_link(0, 1),
            "source": "a peer copy of one flagship bucket block, cuda:0 -> cuda:1"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splats", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--devices", type=int, default=8, help="logical shards")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--link-gbps", type=float, default=PR10_LINK_GBPS,
                    help="link rate where fewer than two cards exist (default: "
                    "from PR 10's four-card run)")
    ap.add_argument("--flagship-splats", type=int, default=FLAG_SPLATS,
                    help="splats of the flagship table (0 = leave it out)")
    ap.add_argument("--json", action="store_true", help="print the JSON line alone")
    opts = ap.parse_args(argv)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_scaling_report: no CUDA device; pass --device cpu")
    say = (lambda *a: None) if opts.json else log
    on_card = device.type == "cuda"
    report = {"device": torch.cuda.get_device_name(0) if on_card else "cpu",
              "cards": torch.cuda.device_count() if on_card else 0}

    # ---- the default scene and its cross-check --------------------------
    w, h, ndev = opts.width, opts.height, opts.devices
    params, args, cfg = frame_of(opts.splats, 42, w, h, 128, 6.0, (-5.5, -3.2), device)
    bounds = tile_bounds(params, args, w, h, cfg)
    mesh, runs_on = mesh_of(ndev, device)
    padded = sh.pad_scene_for_mesh(params, ndev)
    with torch.no_grad():
        _, stats = fs.render_fast_sharded(padded, *args, w, h, cfg, mesh)
    link = link_rate(PR10_BLOCK_BYTES, device, opts.link_gbps)
    scene = dict(splats=opts.splats, width=w, height=h, tiles=cfg.num_tiles,
                 **distribution(bounds, ndev, w, h, cfg, link["gbps"]))
    exchanged = int(stats["exchanged_records"])
    scene["cross_check"] = {"exchanged_records": exchanged,
                            "overflow": int(stats["overflow"]), "runs_on": runs_on,
                            "equal": exchanged == scene["binned_records"]}
    assert exchanged == sum(scene["per_owner_records"]) == scene["binned_records"], (
        f"the sharded frame exchanged {exchanged} records, the layout bins "
        f"{scene['binned_records']}")
    report.update(link=link, scene=scene)
    say(f"device {report['device']}; link {link['gbps']:.1f} GB/s ({link['source']})")
    say(f"{opts.splats} splats at {w}x{h}, {cfg.num_tiles} tiles, {ndev} shards: "
        f"{scene['binned_records']} binned records; per owner "
        f"{scene['per_owner_records']} (max/mean {scene['records_imbalance']:.3f}); "
        f"pair work max/mean {scene['pairs_imbalance']:.3f}; efficiency bound "
        f"{scene['efficiency_bound']:.1%}; exchange {scene['exchange_bytes'] / 1e6:.1f} MB, "
        f"{scene['exchange_ms']:.3f} ms; render_fast_sharded ({runs_on}) exchanged "
        f"{exchanged}, overflow {scene['cross_check']['overflow']}")
    del params, padded, mesh

    # ---- the flagship at 1, 2, 4, 8 shards ------------------------------
    if opts.flagship_splats:
        params, args, cfg = frame_of(opts.flagship_splats, 99, FLAG_W, FLAG_H, 256, 2.0,
                                     (-5.8, -3.6), device)
        bounds = tile_bounds(params, args, FLAG_W, FLAG_H, cfg)
        single = None
        if on_card:
            with torch.no_grad():
                single = frame_ms(lambda: render_arrays(params, *args, FLAG_W, FLAG_H, cfg))
        table = []
        for d in FLAG_SHARDS:
            row = distribution(bounds, d, FLAG_W, FLAG_H, cfg, link["gbps"])
            row["bound_frame_ms"] = (None if single is None else
                                     single / row["efficiency_bound"] / d + row["exchange_ms"])
            row["bound_fps"] = (None if single is None else 1e3 / row["bound_frame_ms"])
            row["measured_frame_ms"] = row["measured_on"] = None
            if d == 1 and single is not None:
                row["measured_frame_ms"], row["measured_on"] = single, "one card"
            elif on_card and torch.cuda.device_count() >= d:
                mesh = sh.make_mesh(d)
                padded = sh.pad_scene_for_mesh(params, d)
                with torch.no_grad():
                    row["measured_frame_ms"] = frame_ms(
                        lambda: fs.render_fast_sharded(padded, *args, FLAG_W, FLAG_H, cfg,
                                                       mesh))
                row["measured_on"] = f"{d} cards"
                del padded, mesh
            for k in ("per_owner_records", "per_owner_pair_work"):
                row[f"max_owner_{k[10:]}"] = max(row.pop(k))
            table.append(row)
        report["flagship"] = {"splats": opts.flagship_splats, "width": FLAG_W,
                              "height": FLAG_H, "tiles": cfg.num_tiles,
                              "single_frame_ms": single, "table": table,
                              "pr10_four_card_frame_ms": list(PR10_FOUR_CARD_FRAME_MS)}
        say(f"flagship {opts.flagship_splats} splats at {FLAG_W}x{FLAG_H}: one device "
            f"{'not measured' if single is None else f'{single:.3f} ms'}")
        say("shards | max owner records | pair max/mean | eff bound | exchange MB | "
            "exchange ms | bound ms | bound fps | measured ms")
        for r in table:
            def fmt(x, f):
                return "not measured" if x is None else format(x, f)
            say(f"{r['devices']} | {r['max_owner_records']} | {r['pairs_imbalance']:.3f} | "
                f"{r['efficiency_bound']:.1%} | {r['exchange_bytes'] / 1e6:.1f} | "
                f"{r['exchange_ms']:.3f} | {fmt(r['bound_frame_ms'], '.3f')} | "
                f"{fmt(r['bound_fps'], '.1f')} | {fmt(r['measured_frame_ms'], '.3f')}")
        say(f"PR 10's four-card sharded frame (PERF.md): {PR10_FOUR_CARD_FRAME_MS} ms")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
