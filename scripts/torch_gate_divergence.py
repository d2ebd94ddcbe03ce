#!/usr/bin/env python3
"""Attribute the pixels where two frames of the port differ to threshold
flips, by a float64 replay of draw.glsl's blend.

The port's counterpart of ``scripts/gate_divergence.py``, on CUDA only:

    python3 scripts/torch_gate_divergence.py              # gate scene
    python3 scripts/torch_gate_divergence.py --frame q16  # flagship q16

``--frame gate`` (the default) renders the 10,000-splat gate scene of
``bench.py:147-157`` (512x512, 32 px tiles, chunk 256, capacity factor 8,
``max_per_tile`` 2048, camera (0, 0, -6)) with the kernels
(``use_pallas=True``) and with the oracle, and lists the pixels whose
largest channel differs by more than 1e-3. The two compositors round
``exp`` and the running transmittance differently, so a record whose alpha
sits on the 1/255 cutoff (draw.glsl:123) or whose blend brings the
transmittance onto the 0.99 saturation break (draw.glsl:129) can land on
either side. For each such pixel the script takes the kernels' sorted
record stream (``fastpath.expand_depth_records`` + ``sort_records``),
replays the pixel's blend in float64, and names every record within
``FLIP_EPS`` of a branch (``alpha_min`` or ``saturation``) with the pixel
change that flipping it predicts.

``--frame q16`` renders the uniform flagship (3,616,103 splats at
1024x512, camera (0, 0, -8)) on the packed key with f32 records and with
q16 records (``Splats(inference=True)``). Both sorts take the same keys, so
record k of one stream is record k of the other; for each pixel the
replay runs on both streams and names the first record whose branch
differs between them (``alpha_min``: kept in one, not the other;
``saturation``: the blend stops after it in one only), or ``values`` where
no branch differs and the quantised fields alone move the pixel (with the
record that moves it most). Each stream's borderline records are listed
as in the gate mode: a pixel the replays of the two streams do not tell
apart can still differ where one frame's float32 rounding took such a
record to the other side.

``--frame packed`` renders the uniform flagship on the exact pair key and
on the packed key (22 bits of depth: records of one tile whose quantised
depths are equal tie and keep splat order, where the pair key orders them
by float depth). Both sorts take the same records, so for each pixel the
replay runs the tile's records in both orders, names the tied records that
the two orders place differently and that the pixel blends (record,
packed key, depth, alpha), and compares the replayed change with the
observed one; a pixel with no such tie behind it is unexplained, a fault.

Logs go to stderr; the last line of stdout is one JSON object:
``{"frame", "max_diff", "bad_px", "explained", "findings": [...]}``, a
finding per pixel. A pixel is explained when the change a named record predicts is within 35% of the
observed change. Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
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
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import padded_dims  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.render import (  # noqa: E402
    autotune_capacity,
    camera_args,
    render_arrays,
)
from openglgaussiansplattingrenderer_tpu_torch.splats import inference_config  # noqa: E402

FLIP_EPS = 3e-6          # window around a branch threshold, in alpha or T
MATCH = 0.35             # a predicted change explains an observed one within this share
BAD = 1e-3               # a pixel differs where its largest channel moves more


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gate_frame(device):
    """(params, args, cfg) of the gate scene on ``device``, kernels on."""
    w = h = 512
    cfg = RenderConfig.for_resolution(w, h, tile_px=32, use_pallas=True, chunk=256,
                                      dup_capacity_factor=8.0, max_per_tile=2048)
    scene = ply_io.make_synthetic_scene(10_000, seed=7, extent=2.5)
    params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"},
                               device)
    a = camera_args(Camera(0.0, 0.0, -6.0, width=w, height=h))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], w, h)
    return params, args, cfg


def flagship_frame(device):
    """(params, args, cfg) of the uniform flagship on ``device``, on the
    packed key with the capacity tuned to the frame."""
    w, h = 1024, 512
    cfg = RenderConfig.for_resolution(w, h, tile_px=32, chunk=256, depth_key="packed")
    scene = ply_io.make_synthetic_scene(3_616_103, seed=99, extent=3.0,
                                        log_scale_range=(-5.8, -3.6))
    params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"},
                               device)
    a = camera_args(Camera(0.0, 0.0, -8.0, width=w, height=h))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], w, h)
    return params, args, autotune_capacity(params, *args, cfg)


class Stream:
    """A (tile, depth)-sorted record stream as the kernels' compositor reads
    it: fields (9, C) mx, my, A, B, C, op, r, g, b and bounds (T+1,). A
    tile's records come to the host, in float64, when a replay needs them."""

    def __init__(self, params, args, cfg):
        w, h = args[6], args[7]
        dev = params["means"].device
        view, vp = (torch.as_tensor(m, dtype=torch.float32, device=dev) for m in args[:2])
        with torch.no_grad():
            rec = fastpath.expand_depth_records(params, view, vp, *args[2:], cfg,
                                                key=fastpath.record_key(cfg))
            self.fields, bounds = fastpath.sort_records(*rec, w, h, cfg)
        self.bounds = bounds.cpu().numpy().astype(np.int64)
        wp, hp = padded_dims(w, h, cfg)
        self.pw, self.ph, self.gx = wp // cfg.grid_x, hp // cfg.grid_y, cfg.grid_x
        self._tiles = {}

    def tile_of(self, px, py):
        return (py // self.ph) * self.gx + px // self.pw

    def records(self, t):
        """(first record index, (9, n) float64 records) of tile ``t``."""
        if t not in self._tiles:
            lo, hi = self.bounds[t], self.bounds[t + 1]
            self._tiles[t] = (int(lo), self.fields[:, lo:hi].double().cpu().numpy())
        return self._tiles[t]


def blend(rec, px, py, cfg, kept=None, stop=None):
    """draw.glsl's per-pixel loop over one tile's records in float64.

    Returns (pixel (r, g, b, alpha) as the image holds it, alpha (n,),
    kept (n,), transmittance before each record (n,), stop): records
    [0, stop) are reached; the loop breaks after the record whose blend
    brings the transmittance to 1 - saturation or below. ``kept`` and
    ``stop`` override the two branches, to predict what a flip changes."""
    mx, my, A, B, C, op = rec[:6]
    dx, dy = px - mx, py - my
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = np.minimum(np.exp(power) * op, cfg.alpha_max)
    if kept is None:
        kept = (power <= 0.0) & (alpha >= cfg.alpha_min)
    a_k = np.where(kept, alpha, 0.0)
    t_after = np.cumprod(1.0 - a_k)
    t_before = np.concatenate([[1.0], t_after[:-1]])
    if stop is None:
        crossed = np.flatnonzero(kept & (t_after <= 1.0 - cfg.saturation))
        stop = int(crossed[0]) + 1 if crossed.size else alpha.size
    w = np.where(np.arange(alpha.size) < stop, a_k * t_before, 0.0)
    t_final = t_after[stop - 1] if stop else 1.0
    rgb = (rec[6:9] * w).sum(axis=1) / cfg.color_scale
    bg = np.asarray(cfg.background, np.float64)
    return np.concatenate([rgb + t_final * bg, [1.0 - t_final]]), alpha, kept, t_before, stop


def _change(a, b):
    return float(np.abs(a - b).max())


def borderline(rec, px, py, cfg):
    """Records of the reached part of the blend within FLIP_EPS of a branch,
    each with the pixel change its flip predicts."""
    pixel, alpha, kept, t_before, stop = blend(rec, px, py, cfg)
    out = []
    thresh = 1.0 - cfg.saturation
    for k in range(stop):
        if abs(alpha[k] - cfg.alpha_min) < FLIP_EPS:
            flipped = kept.copy()
            flipped[k] = not kept[k]
            out.append({"record": k, "branch": "alpha_min",
                        "margin": float(alpha[k] - cfg.alpha_min),
                        "predicted_diff": _change(blend(rec, px, py, cfg, kept=flipped)[0],
                                                  pixel)})
        if kept[k] and abs(thresh - t_before[k] * (1.0 - alpha[k])) < FLIP_EPS:
            if stop == k + 1:      # broke here: the other side blends on
                later = np.flatnonzero(kept[k + 1:])
                other = k + 2 + int(later[0]) if later.size else alpha.size
            else:                  # blended on: the other side breaks here
                other = k + 1
            out.append({"record": k, "branch": "saturation",
                        "margin": float(t_before[k] * (1.0 - alpha[k]) - thresh),
                        "predicted_diff": _change(blend(rec, px, py, cfg, stop=other)[0],
                                                  pixel)})
    return out


def _matches(pred, diff):
    return abs(pred - diff) < MATCH * max(pred, diff)


def bad_pixels(img_a, img_b):
    """(max abs diff, [(px, py, diff)] of pixels whose largest channel
    differs by more than BAD), from two (H, W, 4) tensors."""
    d = (img_a.double() - img_b.double()).abs().amax(dim=-1)
    ys, xs = np.nonzero((d > BAD).cpu().numpy())
    dn = d.cpu().numpy()
    return float(dn.max()), [(int(x), int(y), float(dn[y, x])) for y, x in zip(ys, xs)]


def attribute(stream, bad, cfg):
    """One finding per bad pixel: its borderline records on ``stream`` and
    whether one of them predicts the observed change."""
    findings = []
    for px, py, diff in bad:
        t = stream.tile_of(px, py)
        lo, rec = stream.records(t)
        culprits = borderline(rec, px, py, cfg)
        for c in culprits:
            c["record"] += lo
            c["matches"] = _matches(c["predicted_diff"], diff)
        findings.append({"px": [px, py], "tile": int(t), "diff": diff,
                         "culprits": culprits,
                         "explained": any(c["matches"] for c in culprits)})
    return findings


def attribute_two_streams(f32, q16, bad, cfg):
    """One finding per bad pixel of the q16 frame against the f32 frame:
    both streams replayed, the first record whose branch differs named."""
    findings = []
    for px, py, diff in bad:
        t = f32.tile_of(px, py)
        lo, rec_f = f32.records(t)
        _, rec_q = q16.records(t)
        pix_f, a_f, kept_f, tb_f, stop_f = blend(rec_f, px, py, cfg)
        pix_q, a_q, kept_q, tb_q, stop_q = blend(rec_q, px, py, cfg)
        predicted = _change(pix_q, pix_f)
        reach = min(stop_f, stop_q)
        flips = np.flatnonzero(kept_f[:reach] != kept_q[:reach])
        if flips.size:
            k = int(flips[0])
            branch = {"record": lo + k, "branch": "alpha_min",
                      "alpha_f32": float(a_f[k]), "alpha_q16": float(a_q[k])}
        elif stop_f != stop_q:
            k = reach - 1
            branch = {"record": lo + k, "branch": "saturation",
                      "t_after_f32": float(tb_f[k] * (1 - a_f[k]) if kept_f[k] else tb_f[k]),
                      "t_after_q16": float(tb_q[k] * (1 - a_q[k]) if kept_q[k] else tb_q[k])}
        else:
            w_f = np.where(np.arange(a_f.size) < stop_f, np.where(kept_f, a_f, 0) * tb_f, 0)
            w_q = np.where(np.arange(a_q.size) < stop_q, np.where(kept_q, a_q, 0) * tb_q, 0)
            moved = np.abs(rec_q[6:9] * w_q - rec_f[6:9] * w_f).max(axis=0) / cfg.color_scale
            k = int(np.argmax(moved))
            branch = {"record": lo + k, "branch": "values",
                      "largest_record_change": float(moved[k])}
        # either frame's own float32 rounding can take a record within
        # FLIP_EPS of a branch to the other side than the float64 replay
        explained = _matches(predicted, diff)
        for name, rec in (("f32_borderline", rec_f), ("q16_borderline", rec_q)):
            for c in borderline(rec, px, py, cfg):
                c["record"] += lo
                c["matches"] = _matches(c["predicted_diff"], diff)
                explained |= c["matches"]
                branch.setdefault(name, []).append(c)
        findings.append({"px": [px, py], "tile": int(t), "diff": diff,
                         "replayed_diff": predicted, **branch,
                         "records_reached": [stop_f, stop_q],
                         "explained": explained})
    return findings


class TiedStreams:
    """One frame's records in two stable (tile, depth) orders, the exact
    pair key's and the packed key's. ``tile(t)`` gives the tile's records
    (9, n) float64 in each order, the records' indices in the unsorted
    record array and packed keys in packed order, and each packed-order
    record's position in the pair order."""

    def __init__(self, params, args, cfg):
        w, h = args[6], args[7]
        dev = params["means"].device
        view, vp = (torch.as_tensor(m, dtype=torch.float32, device=dev) for m in args[:2])
        t = cfg.num_tiles
        with torch.no_grad():
            self.fields, rec_t, rec_d, _ = fastpath.expand_depth_records(
                params, view, vp, *args[2:], cfg)
            self.orders, self.bounds = [], []
            for key, shift in ((kr.pair_key(rec_t, rec_d), 32),
                               (kr.packed_key(rec_t, rec_d), kr.PACKED_DEPTH_BITS)):
                sk, order = torch.sort(key, stable=True)
                edges = torch.arange(t + 1, dtype=torch.int64, device=dev) << shift
                self.orders.append(order)
                self.bounds.append(torch.searchsorted(sk, edges).cpu().numpy())
                if shift != 32:
                    self.packed_sorted = sk
            self.depth = rec_d
        wp, hp = padded_dims(w, h, cfg)
        self.pw, self.ph, self.gx = wp // cfg.grid_x, hp // cfg.grid_y, cfg.grid_x
        self._tiles = {}

    def tile_of(self, px, py):
        return (py // self.ph) * self.gx + px // self.pw

    def tile(self, t):
        if t not in self._tiles:
            self._tiles[t] = self._tile(t)
        return self._tiles[t]

    def _tile(self, t):
        (bp, bq), (op, oq) = self.bounds, self.orders
        p_ids = op[bp[t]:bp[t + 1]]
        q_ids = oq[bq[t]:bq[t + 1]]
        p_np, q_np = p_ids.cpu().numpy(), q_ids.cpu().numpy()
        inv = np.argsort(p_np)
        return {"pair": self.fields[:, p_ids].double().cpu().numpy(),
                "packed": self.fields[:, q_ids].double().cpu().numpy(),
                "ids": q_np,
                "keys": self.packed_sorted[bq[t]:bq[t + 1]].cpu().numpy(),
                "depth": self.depth[q_ids].double().cpu().numpy(),
                "pair_pos": inv[np.searchsorted(p_np[inv], q_np)]}


def reordered_ties(keys, pair_pos):
    """Packed-order positions of records that tie on the packed key with a
    neighbour and stand elsewhere in their tie group in the pair order."""
    out = []
    start = 0
    for k in range(1, len(keys) + 1):
        if k == len(keys) or keys[k] != keys[start]:
            if k - start > 1:
                grp = pair_pos[start:k]
                out += [start + i for i in np.flatnonzero(grp != np.sort(grp))]
            start = k
    return np.asarray(out, np.int64)


def attribute_ties(streams, bad, cfg):
    """One finding per bad pixel of the packed frame against the pair
    frame: the replayed change of the two orders, and the reordered tied
    records the pixel blends."""
    findings = []
    for px, py, diff in bad:
        t = streams.tile_of(px, py)
        tl = streams.tile(t)
        pix_p, _, _, _, _ = blend(tl["pair"], px, py, cfg)
        pix_q, a_q, kept_q, _, stop_q = blend(tl["packed"], px, py, cfg)
        replayed = _change(pix_q, pix_p)
        tied = [int(k) for k in reordered_ties(tl["keys"], tl["pair_pos"])
                if k < stop_q and kept_q[k]]
        named = [{"record": int(tl["ids"][k]), "packed_key": int(tl["keys"][k]),
                  "depth": float(tl["depth"][k]), "alpha": float(a_q[k])} for k in tied]
        explained = bool(named) and _matches(replayed, diff)
        if named and not explained:
            # a threshold flip inside either frame's float32 rounding
            for rec in (tl["pair"], tl["packed"]):
                explained |= any(_matches(c["predicted_diff"], diff)
                                 for c in borderline(rec, px, py, cfg))
        findings.append({"px": [px, py], "tile": int(t), "diff": diff,
                         "replayed_diff": replayed, "tied_records": named,
                         "explained": explained})
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", choices=("gate", "q16", "packed"), default="gate")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("torch_gate_divergence: no CUDA device; nothing was run")
        return 1
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}")
    with torch.no_grad():
        if opts.frame == "gate":
            params, args, cfg = gate_frame(dev)
            img_a, _ = render_arrays(params, *args, cfg)
            img_b, st = render_arrays(params, *args,
                                      dataclasses.replace(cfg, use_pallas=False))
            assert int(st["dropped_by_cap"]) == 0, "the oracle dropped records"
            max_diff, bad = bad_pixels(img_a, img_b)
            log(f"kernels vs oracle: max abs diff {max_diff:.3e}; {len(bad)} px > {BAD}")
            findings = attribute(Stream(params, args, cfg), bad, cfg)
        elif opts.frame == "packed":
            params, args, cfg = flagship_frame(dev)
            pair = dataclasses.replace(cfg, depth_key="pair")
            img_a, _ = render_arrays(params, *args, cfg)
            img_b, _ = render_arrays(params, *args, pair)
            max_diff, bad = bad_pixels(img_a, img_b)
            log(f"packed vs pair: max abs diff {max_diff:.3e}; {len(bad)} px > {BAD}")
            findings = attribute_ties(TiedStreams(params, args, pair), bad, cfg)
        else:
            params, args, cfg = flagship_frame(dev)
            q16 = inference_config(cfg)
            img_a, _ = render_arrays(params, *args, q16)
            img_b, _ = render_arrays(params, *args, cfg)
            max_diff, bad = bad_pixels(img_a, img_b)
            log(f"q16 vs f32: max abs diff {max_diff:.3e}; {len(bad)} px > {BAD}")
            findings = attribute_two_streams(Stream(params, args, cfg),
                                             Stream(params, args, q16), bad, cfg)
    for f in sorted(findings, key=lambda f: -f["diff"])[:20]:
        log(json.dumps(f))
    n_exp = sum(f["explained"] for f in findings)
    log(f"{n_exp}/{len(findings)} pixels explained by the float64 replay")
    print(json.dumps({"frame": opts.frame, "max_diff": max_diff, "bad_px": len(bad),
                      "explained": n_exp, "findings": findings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
