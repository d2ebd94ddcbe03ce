"""Render configuration.

Every magic number hard-coded in the reference becomes a config field here with
the reference's value as the default (SURVEY.md section 5, "Config / flag system"):

- 16x16 tile grid        -> ``grid_x`` / ``grid_y``   (ref ``shaders/preprocess.glsl:143-149``)
- 2x duplicate capacity  -> ``dup_capacity_factor``   (ref ``src/Splats.cpp:95-102``)
- 0.3 dilation           -> ``dilation``              (ref ``shaders/preprocess.glsl:127-128``)
- 3-sigma radius         -> ``radius_sigma``          (ref ``shaders/preprocess.glsl:142``)
- 1/255 alpha cutoff     -> ``alpha_min``             (ref ``shaders/draw.glsl:123``)
- 0.99 alpha clamp       -> ``alpha_max``             (ref ``shaders/draw.glsl:122``)
- 0.99 saturation        -> ``saturation``            (ref ``shaders/draw.glsl:129``)
- 1.3*tanFov view clamp  -> ``fov_margin``            (ref ``shaders/preprocess.glsl:111-116``)
- 1e-4 w clamp           -> ``w_eps``                 (ref ``shaders/preprocess.glsl:78``)
- colours in 0..255      -> ``color_scale``           (ref ``src/Splats.cpp:295``, ``draw.glsl:141``)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) configuration for the rendering pipeline."""

    # Tile grid: the screen is split into grid_x * grid_y tiles; one packed
    # (tile, depth) key per record makes a single sort produce per-tile
    # depth-ordered ranges (ref shaders/preprocess.glsl:143-154).
    grid_x: int = 16
    grid_y: int = 16

    # Record capacity = dup_capacity_factor * num_splats, statically shaped.
    # The reference sizes its duplicate-capable buffers at 2x numSplats
    # (src/Splats.cpp:95-102) and clamps the duplicate count; we drop overflow
    # records and report the overflow count as a metric instead of a host sync.
    dup_capacity_factor: float = 2.0

    # Exact record capacity, overriding dup_capacity_factor when set.
    # Capacity bounds the record sort + expand cost (first-order perf knob),
    # so production callers measure the scene's real record count and pin
    # capacity to it -- see ``render.autotune_capacity``.
    capacity_records: int | None = None

    # EWA projection constants (shaders/preprocess.glsl).
    dilation: float = 0.3
    radius_sigma: float = 3.0
    fov_margin: float = 1.3
    w_eps: float = 1e-4
    eig_floor: float = 0.1  # max(0.1, ...) under the sqrt, preprocess.glsl:140-141

    # Compositing constants (shaders/draw.glsl).
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    saturation: float = 0.99

    # Colours are stored pre-scaled to 0..255 at load (src/Splats.cpp:295) and
    # divided back down at the end of draw (shaders/draw.glsl:141).
    color_scale: float = 255.0

    # Background colour composited behind the splats (reference clears to 0).
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # Depth-key mode:
    #   "pair"      - lexicographic (tile:int32, depth:float32) sort; full float
    #                 depth precision at any tile count (TPU-native design).
    #   "packed"    - fast path (hoist_depth_sort=False) only: one u32 key =
    #                 tile * 2^22 + 22-bit-quantized ndc depth. One key
    #                 operand fewer on the record sort; strictly MORE depth
    #                 precision than the reference's own packed float key
    #                 (~14 effective bits at hundreds of tiles), but not the
    #                 "pair" mode's exact f32 (same-bucket ties fall back to
    #                 splat order). num_tiles <= 512.
    #   "reference" - single float32 key = tileIndex + ndc_z in [0,1)
    #                 (ref shaders/preprocess.glsl:154); loses depth precision
    #                 as tileIndex grows; kept for parity testing.
    depth_key: str = "pair"

    # Record-sort engine for the single-key fast paths (depth_key="packed"
    # or hoist_depth_sort=True):
    #   "lax"   - jax.lax.sort payload sort (default; the measured floor of
    #             this hardware generation, ARCHITECTURE.md dead-ends).
    #   "radix" - the complete TPU-native 3-phase distribution sort
    #             (ops/pallas/radix_sort.py), the reference's sort library
    #             (src/sort.cpp:139-203) re-designed for Mosaic: exact,
    #             stable, differentiable; measured slower than lax.sort
    #             (scripts/radix_sort_bench.py), kept selectable for parity.
    # The two-f32-key "pair" mode and the oracle path always use lax.sort.
    record_sort: str = "lax"

    # Record-sort payload precision (fast path; depth_key="packed" +
    # record_sort="lax" only):
    #   "f32" - exact payload sort (default; training and the bench's
    #           oracle gate use this).
    #   "q16" - INFERENCE-ONLY speed mode: the 9 record fields ride the
    #           dominant record sort packed into 5 u32 lanes (24-bit
    #           fixed-point means, f16 conics+colours, 16-bit opacity),
    #           cutting the sort's operand count 11 -> 6. Differentiating
    #           through it raises. Image error is measured well inside the
    #           reference's own CPU-vs-GPU assert tolerance of 0.01
    #           (src/Splats.cpp:783-843) -- tests/test_q16.py; the bench
    #           reports it as the separate `flagship_fps_inference` field.
    #           The SHARDED render honours it too (fast_sharded._q16_route):
    #           fields ride the bucket sort, the ICI all-to-all (7 columns
    #           instead of 11) and the owner merge (6 sort operands) packed
    #           -- multi-chip serving's per-chip sorts and exchange traffic
    #           shrink the same way (the sharded path ignores depth_key;
    #           its merge key is always the packed u32 form in q16).
    sort_payload: str = "f32"

    # Static cap on records composited per tile by the jnp fallback compositor
    # (rounded up to chunk size). Overflow is dropped and counted in stats.
    # The Pallas compositor has no such cap (it streams ragged ranges).
    max_per_tile: int = 4096

    # Chunk of records processed per inner step of the compositors (the Pallas
    # analogue of draw.glsl's 1024-splat shared-memory batches).
    chunk: int = 256

    # Use the fused Pallas tile-compositing kernel when available.
    use_pallas: bool = True

    # Fast-path sort strategy. False (default, round 3): no N-sized depth
    # pre-sort; records carry their depth and the C-sized record sort is
    # lexicographic (tile, depth) -- one extra key operand buys deleting a
    # whole N-sized 13-payload sort (measured at the flagship point,
    # 3.6M splats / 1024x512: fwd 162.5 -> 127.5 ms). True restores the
    # round-2 two-sort design: depth-sort splats first, then a stable
    # single-key tile sort; overflow then drops farthest records first
    # instead of in splat order -- prefer autotuned capacity
    # (render.autotune_capacity) where overflow ordering matters.
    # The two modes are image-identical under zero overflow: stable sorts
    # resolve exact (tile, depth) ties to original splat order either way.
    hoist_depth_sort: bool = False

    # Spherical-harmonic colour degree (0-3). 0 = the reference's
    # view-independent DC colour (it parses but discards the 45 f_rest
    # coefficients, Splats.cpp:301-302); 1-3 evaluate the full basis when
    # params carry "sh_rest".
    sh_degree: int = 0

    # Replicate the reference GPU preprocess quirk of computing the tile size
    # with integer division (preprocess.glsl:143) instead of float division
    # (Splats.cpp:596). Only differs when width/height % grid != 0.
    int_tile_size: bool = False

    # Tighten each splat's tile rectangle from the reference's 3-sigma
    # bounding square (preprocess.glsl:139-149) to its intersection with the
    # opacity-aware ellipse AABB of the {alpha >= alpha_min} set. Image-exact:
    # a tile strictly outside that AABB contains no pixel the reference's own
    # per-pixel cutoff (draw.glsl:118-126) would blend, so the dropped
    # records contribute exactly zero -- they just stop being allocated,
    # sorted, and streamed. False recovers the reference's rectangle (and its
    # duplicate-count statistics) exactly.
    tight_rect: bool = True

    # Anti-aliased ("opacity compensation") mode, off by default (the
    # reference has no AA): scale each splat's opacity by
    # sqrt(det(cov2D) / det(cov2D + dilation*I)) so the screen-space
    # dilation (preprocess.glsl:126-128's +0.3) preserves each Gaussian's
    # total integrated contribution instead of brightening sub-pixel splats.
    # This is the standard compensation used by Mip-Splatting-style
    # renderers; scenes trained with it need it on to render correctly.
    antialiased: bool = False

    def __post_init__(self):
        # Typos like "Radix"/"radix " would silently fall back to the other
        # engine at plain equality checks (ops/fastpath.py) -- fail loudly.
        if self.record_sort not in ("lax", "radix"):
            raise ValueError(
                f"record_sort must be 'lax' or 'radix', got "
                f"{self.record_sort!r}")
        if self.depth_key not in ("pair", "packed", "reference"):
            raise ValueError(
                f"depth_key must be 'pair', 'packed' or 'reference', got "
                f"{self.depth_key!r}")
        if self.sort_payload not in ("f32", "q16"):
            raise ValueError(
                f"sort_payload must be 'f32' or 'q16', got "
                f"{self.sort_payload!r}")
        if self.sort_payload == "q16" and self.record_sort != "lax":
            raise ValueError(
                "sort_payload='q16' packs lax.sort payload lanes; it does "
                "not compose with record_sort='radix'")

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    def tile_size(self, width: int, height: int) -> Tuple[float, float]:
        """Pixel size of one tile (tile_w, tile_h)."""
        if self.int_tile_size:
            return float(width // self.grid_x), float(height // self.grid_y)
        return width / self.grid_x, height / self.grid_y

    @classmethod
    def for_resolution(cls, width: int, height: int, tile_px: int = 32,
                       **overrides) -> "RenderConfig":
        """Config with a tile grid sized for the resolution.

        The reference hard-codes 16x16 tiles for its 1024x512 target (64x32px
        tiles); at 1080p/4K that makes tiles too large for VMEM blocking, so
        production configs pick the grid from a target tile pixel size
        (default 32x32px -> P=1024 pixels per tile, 8x128 vector-register
        perfect). The image is padded up to the grid (cropped after).
        """
        gx = max(1, -(-width // tile_px))
        gy = max(1, -(-height // tile_px))
        return cls(grid_x=gx, grid_y=gy, **overrides)

    def capacity(self, num_splats: int) -> int:
        """Static record capacity for a scene with ``num_splats`` splats."""
        if self.capacity_records is not None:
            cap = int(self.capacity_records)
        else:
            cap = int(self.dup_capacity_factor * num_splats)
        # Round up to a multiple of the chunk size so Pallas DMA slices are
        # uniform; padding records carry a sentinel tile id.
        c = max(cap, self.chunk)
        return -(-c // self.chunk) * self.chunk
