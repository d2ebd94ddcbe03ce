"""Multi-device sharded rendering and training: the mesh, its collectives,
and the round-1 oracle.

Counterpart of ``openglgaussiansplattingrenderer_tpu/parallel/sharded.py``.
The JAX package runs one program over a ``Mesh`` of local devices with
``shard_map``; the port keeps that shape as a **single controller over a
list of devices**: ``Mesh`` holds an explicit ``torch.device`` per shard
(a device may repeat, so D logical shards can share one card or the CPU),
each shard's body runs in a Python loop under its device, and the
collectives are tensor moves (``torch.cat``, ``split`` and ``.to``) over
lists holding one tensor per shard. Autograd differentiates through them,
so each collective's transpose comes for free: the tiled ``all_gather``
transposes to a reduce-scatter, ``all_to_all`` to the reverse
all-to-all, ``psum`` to a broadcast. A shard's body never waits for the
device (no ``.item()``, no host copy), so shards on distinct GPUs overlap.

The collectives are methods of the mesh, and a body loops over
``mesh.local``, the (shard index, device) pairs this controller runs: all
of them here, the one shard of its rank on ``parallel.multihost``'s
process mesh, whose methods run the same collectives through
``torch.distributed``. ``Mesh2D`` is a (view x splat) grid whose rows are
1-D meshes (``parallel/mesh2d.py``).

Design of the oracle (round 1, plain PyTorch, no kernel):

- **splat-sharded preprocess**: each shard projects and duplicates its N/D
  splats into a local capacity-padded record array;
- **record all-gather**: the 9 record fields, the tile and the depth of
  every record go to every shard;
- **replicated sort, tile-sharded composite**: every shard sorts the
  gathered records by (tile, depth), stable, and composites its own
  contiguous stripe of tiles with the oracle's dense compositor;
- **backward**: a splat duplicated across tiles of different shards
  receives the exact sum of its contributions, by construction (the
  all-gather's transpose sums them back to the owning shard).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import binning, projection, sorting
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import (
    assemble_image,
    composite_ranges,
    tile_pixel_coords,
)
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance

AXIS = "dev"
VIEW_AXIS, SPLAT_AXIS = "view", "splat"     # the axes of a Mesh2D

Params = Dict[str, torch.Tensor]


class Mesh:
    """One mesh axis (``AXIS``) over an explicit list of devices, shard d on
    ``devices[d]``, all run by this controller. The output of a sharded
    frame lies on ``devices[0]``.

    Collectives take a list holding one tensor per local shard (here: every
    shard, in shard order) and return one per local shard."""

    def __init__(self, devices: Sequence[Union[torch.device, str]]):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS: self.size}

    @property
    def local(self):
        """(shard index, device) of each shard this controller runs."""
        return list(enumerate(self.devices))

    @property
    def out_device(self) -> torch.device:
        """Where ``gather`` puts its result."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def local_shards(self, params) -> List[Params]:
        """``params`` as one dict per local shard: a global dict is split by
        ``shard_params``; a list of per-shard dicts is taken as it is."""
        if isinstance(params, dict):
            return shard_params(params, self)
        if len(params) != self.size:
            raise ValueError(f"{len(params)} parameter shards for {self.size} devices")
        return list(params)

    def all_gather(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled all-gather on axis 0: every shard receives the
        concatenation of all shards' tensors in shard order
        (``jax.lax.all_gather(tiled=True)``). Its transpose is a
        reduce-scatter."""
        return [torch.cat([x.to(dev) for x in xs]) for dev in self.devices]

    def all_to_all(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``:
        each shard's tensor is split on axis 0 into D equal blocks; shard d
        receives block d of every shard, concatenated in shard order. Its
        transpose is the reverse all-to-all."""
        d = self.size
        for x in xs:
            if x.shape[0] % d:
                raise ValueError(f"all_to_all: axis 0 of {tuple(x.shape)} does not "
                                 f"split into {d} blocks")
        blocks = [x.split(x.shape[0] // d) for x in xs]
        return [torch.cat([b[e].to(dev) for b in blocks])
                for e, dev in enumerate(self.devices)]

    def psum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over shards, the same value on every shard: summed in shard
        order on the first device, then copied to each."""
        total = xs[0].to(self.devices[0])
        for x in xs[1:]:
            total = total + x.to(self.devices[0])
        return [total.to(dev) for dev in self.devices]

    def pmean(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [t / self.size for t in self.psum(xs)]

    def gather(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """The concatenation of all shards' tensors in shard order, once, on
        ``out_device``: the input of what the controller computes whole
        (an assembled image and its loss)."""
        return torch.cat([x.to(self.out_device) for x in xs])


class Mesh2D:
    """A (view x splat) grid of devices: ``devices[r][s]`` runs splat shard
    s of view row r. Row r is the 1-D ``Mesh`` ``rows[r]`` over the splat
    axis, whose collectives the splat-sharded frame takes unchanged; a
    device may repeat."""

    def __init__(self, devices):
        rows = [tuple(torch.device(d) for d in row) for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a 2-D mesh needs a non-empty rectangular grid of devices")
        self.devices = tuple(rows)
        self.rows = tuple(Mesh(r) for r in rows)

    @property
    def shape(self) -> Dict[str, int]:
        return {VIEW_AXIS: len(self.devices), SPLAT_AXIS: len(self.devices[0])}

    def __repr__(self) -> str:
        return f"Mesh2D({[[str(d) for d in r] for r in self.devices]})"

    def psum(self, xss: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """Sum over both axes (``xss[r][s]`` of view row r, splat shard s),
        the same value on every device: each row's splat sum
        (``rows[r].psum``), then the rows' sums added in row order on the
        first device and copied to each."""
        row_sums = [row.psum(xs)[0] for row, xs in zip(self.rows, xss)]
        total = row_sums[0].to(self.devices[0][0])
        for x in row_sums[1:]:
            total = total + x.to(self.devices[0][0])
        return [[total.to(dev) for dev in row] for row in self.devices]


def _cuda_cards(n: int) -> List[torch.device]:
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 1 or n > avail:
        raise RuntimeError(
            f"{n} CUDA devices asked for, {avail} present; pass devices=[...] "
            "for a mesh of repeated or CPU devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (any list, repeats allowed: ``["cpu"] * 8``,
    ``["cuda:0"] * 4``) or, without it, over ``n_devices`` distinct CUDA
    devices (default: all of them). Raises when fewer CUDA devices exist
    than asked for: nothing falls back to the CPU."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices given")
        return Mesh(devices)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
    try:
        return Mesh(_cuda_cards(n_devices))
    except RuntimeError as e:
        raise RuntimeError(f"make_mesh: {e}") from None


def make_mesh2d(dv: int, ds: int, devices=None) -> Mesh2D:
    """A (dv x ds) mesh, row-major over ``devices`` (a list of dv * ds,
    repeats allowed: ``["cuda:0"] * 4``, ``["cpu"] * 8``) or, without it,
    over dv * ds distinct CUDA devices. Raises when fewer CUDA devices exist
    than asked for, as ``make_mesh`` does."""
    if dv < 1 or ds < 1:
        raise ValueError(f"a 2-D mesh needs positive dims, got {dv}x{ds}")
    if devices is None:
        try:
            devices = _cuda_cards(dv * ds)
        except RuntimeError as e:
            raise RuntimeError(f"make_mesh2d: {e}") from None
    if len(devices) != dv * ds:
        raise ValueError(f"a {dv}x{ds} mesh needs {dv * ds} devices, {len(devices)} given")
    devices = list(devices)
    return Mesh2D([devices[r * ds:(r + 1) * ds] for r in range(dv)])


def on_device(dev: torch.device):
    """The context a shard's body runs in: its CUDA device made current (the
    kernels launch on the current device's stream), nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# ---- collectives: lists with one tensor per local shard --------------------

def all_gather(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``mesh.all_gather``: the tiled all-gather on axis 0."""
    return mesh.all_gather(xs)


def all_to_all(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``mesh.all_to_all``: the tiled all-to-all on axis 0."""
    return mesh.all_to_all(xs)


def psum(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``mesh.psum``: the sum over shards on every shard."""
    return mesh.psum(xs)


def pmean(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    return mesh.pmean(xs)


# ---- parameters -------------------------------------------------------------

def pad_scene_for_mesh(params: Params, n_devices: int) -> Params:
    """Pad the splat count to a multiple of the mesh size with splats that
    reach no pixel: opacity 0, scale 1e-6, far outside every frustum."""
    n = params["means"].shape[0]
    pad = (-n) % n_devices
    if pad == 0:
        return params
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v)
        padding = torch.zeros((pad,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
        if k == "quats":
            padding[:, 0] = 1.0
        if k == "scales":
            padding[:] = 1e-6
        if k == "means":
            padding[:] = 1e6
        out[k] = torch.cat([v, padding])
    return out


def shard_params(params: Params, mesh: Mesh) -> List[Params]:
    """Split every parameter's rows into D contiguous blocks, block d on
    ``mesh.devices[d]`` (differentiable: the gradients come back to
    ``params``)."""
    n = params["means"].shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} splats not divisible by {mesh.size} devices; "
                         "use pad_scene_for_mesh")
    m = n // mesh.size
    return [{k: v[d * m:(d + 1) * m].to(dev) for k, v in params.items()}
            for d, dev in enumerate(mesh.devices)]


def gather_shards(shards: List[Params], device) -> Params:
    """Per-shard dicts -> one global dict on ``device`` (shard order)."""
    return {k: torch.cat([s[k].to(device) for s in shards]) for k in shards[0]}


def check_tiles(cfg: RenderConfig, mesh: Mesh) -> int:
    """Tiles a shard owns; raises unless they divide evenly."""
    if cfg.num_tiles % mesh.size:
        raise ValueError(f"{cfg.num_tiles} tiles not divisible by {mesh.size} devices")
    return cfg.num_tiles // mesh.size


def matrix_on(m, dev) -> torch.Tensor:
    """A camera matrix (array or tensor on any device) as float32 on ``dev``."""
    return torch.as_tensor(m, dtype=torch.float32).to(dev)


# ---- the oracle ------------------------------------------------------------

def render_sharded(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                   width: int, height: int, cfg: RenderConfig,
                   mesh: Mesh) -> torch.Tensor:
    """Multi-device oracle render: splat-sharded preprocess, all-gathered
    records, tile-sharded composite. ``params`` is a global dict (its row
    count divisible by the mesh size: ``pad_scene_for_mesh``) or one dict
    per shard. Returns the full (H, W, 4) image on ``mesh.devices[0]``.
    Plain PyTorch: it launches no kernel."""
    shards = mesh.local_shards(params)
    tpd = check_tiles(cfg, mesh)
    packed, tiles, depths = [], [], []
    for dev, p in zip(mesh.devices, shards):
        with on_device(dev):
            cov6 = build_covariance(p["scales"], p["quats"])
            prep = projection.preprocess(
                p["means"], cov6, p["opacities"], matrix_on(view, dev),
                matrix_on(vp, dev), width, height, focal_x, focal_y, tan_fovx,
                tan_fovy, cfg)
            recs = binning.expand_records(
                prep["counts"], prep["tile_min"], prep["tile_ext"],
                prep["depth"].detach(), cfg, cfg.capacity(p["means"].shape[0]))
            sid = recs["splat_id"].long()
            pk = torch.cat([prep["mean2d"][sid], prep["conic"][sid],
                            prep["opacity"][sid][:, None], p["colors"][sid]], dim=1)
            packed.append(torch.where(recs["valid"][:, None], pk,
                                      torch.zeros_like(pk)))       # (capL, 9)
            tiles.append(recs["tile"])
            depths.append(recs["depth"])

    packed_g = all_gather(packed, mesh)
    tile_g, depth_g = all_gather(tiles, mesh), all_gather(depths, mesh)
    rgbs, transs = [], []
    for d, dev in enumerate(mesh.devices):
        with on_device(dev):
            row = torch.arange(tile_g[d].shape[0], device=dev)
            tile_s, row_s = sorting.sort_by_tile_depth(tile_g[d], depth_g[d], row)
            rec = packed_g[d][row_s]
            bounds = torch.searchsorted(
                tile_s, torch.arange(cfg.num_tiles + 1, dtype=torch.int32,
                                     device=dev), right=False)
            mine = slice(d * tpd, (d + 1) * tpd)
            pxs, pys = tile_pixel_coords(width, height, cfg, device=dev)
            records = {"mean2d": rec[:, 0:2], "conic": rec[:, 2:5],
                       "opacity": rec[:, 5], "color": rec[:, 6:9]}
            rgb, trans = composite_ranges(
                records, bounds[:-1][mine], bounds[1:][mine], pxs[mine],
                pys[mine], cfg)
            rgbs.append(rgb)
            transs.append(trans)
    out = mesh.devices[0]
    return assemble_image(torch.cat([r.to(out) for r in rgbs]),
                          torch.cat([t.to(out) for t in transs]), width, height, cfg)


# ---- a train step over sharded raw parameters ------------------------------

def step_sharded(raw: List[Params], opt_state: List[dict], optimizer,
                 loss_fn: Callable):
    """One optimizer step over per-shard raw parameters: ``loss_fn(list of
    per-shard activated params) -> (loss, aux)``; the gradients of every
    shard's tensors come in one ``torch.autograd.grad``, and each shard
    applies the port's Adam to its rows (Adam is elementwise, so this is
    the global update). Returns (raw, opt_state, loss, aux)."""
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import params_from_raw

    keys = optimizer.keys
    leaves = [{k: r[k].detach().requires_grad_(True) for k in keys} for r in raw]
    loss, aux = loss_fn([params_from_raw(r) for r in leaves])
    grads = torch.autograd.grad(loss, [r[k] for r in leaves for k in keys])
    new_raw, new_opt = [], []
    with torch.no_grad():
        for i, (r, st) in enumerate(zip(leaves, opt_state)):
            g = dict(zip(keys, grads[i * len(keys):(i + 1) * len(keys)]))
            new, st = optimizer.update(g, st, {k: r[k].detach() for k in keys})
            new_raw.append(new)
            new_opt.append(st)
    return new_raw, new_opt, loss.detach(), aux


def sharded_train_step(raw, opt_state, target, view, vp, focal_x, focal_y,
                       tan_fovx, tan_fovy, *, width: int, height: int,
                       cfg: RenderConfig, mesh: Mesh, optimizer):
    """One step of fitting splats to a target image on the mesh with the
    oracle: sharded forward, collective-backed backward, the port's Adam
    on the sharded rows. ``raw`` is ``shard_params`` of a
    ``trainer.raw_from_params`` dict, ``opt_state`` one
    ``optimizer.init`` per shard; the loss is the MSE of the RGB against
    ``target`` (on ``mesh.devices[0]``). Returns (raw, opt_state, loss)."""

    def loss_fn(params):
        img = render_sharded(params, view, vp, focal_x, focal_y, tan_fovx,
                             tan_fovy, width, height, cfg, mesh)
        return torch.mean((img[..., :3] - target) ** 2), None

    raw, opt_state, loss, _ = step_sharded(raw, opt_state, optimizer, loss_fn)
    return raw, opt_state, loss
