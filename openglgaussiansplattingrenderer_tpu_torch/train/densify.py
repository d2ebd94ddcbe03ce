"""Adaptive density control (clone / split / prune) at a static capacity.

Counterpart of ``openglgaussiansplattingrenderer_tpu/train/densify.py``.
3DGS training grows and shrinks the splat set as it optimises (Kerbl et
al. sec. 5.2: clone small Gaussians under large positional gradients,
split large ones, prune transparent ones). Here, as in the JAX package,
everything is **capacity-static**:

- parameters are allocated once at ``capacity`` rows; a boolean ``alive``
  row mask tracks the live set;
- dead rows carry ``logit_opacity = DEAD_LOGIT`` and ``log_scales =
  DEAD_LOG_SCALE`` (alpha ~2e-9, below the 1/255 cutoff). How the
  renderer drops them depends on ``RenderConfig.tight_rect``: with the
  default ``True`` preprocess gives a dead row a zero-tile rect and it is
  never allocated, on either path; with ``False`` each dead row on screen
  is allocated a record in each tile its few-pixel rect around the
  projected origin touches (up to four) and the expansion kernel's exact
  reachability cull drops them. The oracle (``use_pallas=False``) has no
  cull, so there the dead rows' records stay in those tiles' bins and can
  overflow ``max_per_tile``: the JAX package behaves the same way;
- clone / split take dead slots by rank matching (the k-th strongest
  candidate goes to the k-th free slot) without a host sync, so every
  tensor keeps its shape from one densify step to the next.

The selection statistic is the accumulated, visibility-normalised norm of
the positional gradient (``DensifyConfig.statistic``): ``"screen"``, 3DGS's
own (``trainer.make_train_step`` ``grad_stat``), or ``"world"``.

``make_adaptive_step`` is one iteration of the adaptive loop for a caller
that feeds one view at a time (``fit_scene_adaptive`` runs through it):
the training step with its statistic, the statistic's accumulation, the
densify event and the opacity reset on their schedules, under the spans
``gs.grad_stats``, ``gs.densify`` and ``gs.opacity_reset``.
``densify_and_prune.calls``, ``accumulate_grad_stats.calls`` and
``reset_opacity.calls`` count the calls.

Random draws come from an explicit ``torch.Generator``; the JAX package
draws from a ``jax.random`` key. The two streams differ, so parity tests
inject the draws (``normals``) instead of a seed.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import (
    inverse_sigmoid,
    quat_to_rotmat,
)
from openglgaussiansplattingrenderer_tpu_torch.utils import device as device_
from openglgaussiansplattingrenderer_tpu_torch.utils.timing import span

DEAD_LOGIT = -20.0        # sigmoid(-20) ~ 2e-9 << 1/255
DEAD_LOG_SCALE = -20.0    # radius ~ 0: the dilation's few pixels


def _counted(f):
    """``f`` with ``.calls``, the number of calls made to it."""
    @functools.wraps(f)
    def counting(*args, **kwargs):
        counting.calls += 1
        return f(*args, **kwargs)

    counting.calls = 0
    return counting


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    capacity: int                     # static row count (>= initial splats)
    grad_threshold: float = 2e-4      # accumulated positional-grad trigger
    statistic: str = "screen"         # "screen" (3DGS) | "world"
    percent_dense: float = 0.01       # split if max scale > this * extent
    scene_extent: float = 1.0         # world-space scene radius
    min_opacity: float = 0.005        # prune below this (3DGS default)
    split_factor: float = 1.6         # new scales = old / split_factor
    start_step: int = 50
    stop_step: int = 1_000_000
    interval: int = 100               # densify every N steps
    # Periodic opacity reset (3DGS: every 3000 steps clamp every opacity to
    # the ceiling and wipe the opacity moments); 0 disables.
    opacity_reset_interval: int = 0
    opacity_reset_ceiling: float = 0.01
    # World-size prune (3DGS's big_points_ws): past iteration
    # big_prune_after, rows whose largest scale exceeds big_scale_frac *
    # scene_extent die with the transparent ones (3DGS: 0.1 past the first
    # opacity reset, 3000); 0 disables.
    big_scale_frac: float = 0.0
    big_prune_after: int = 0

    def densifies_at(self, i: int) -> bool:
        """Whether iteration ``i`` ends with a densify event."""
        return self.start_step <= i < self.stop_step and i > 0 and i % self.interval == 0

    def resets_opacity_at(self, i: int) -> bool:
        """Whether iteration ``i`` ends with an opacity reset."""
        return (self.opacity_reset_interval > 0 and 0 < i < self.stop_step
                and i % self.opacity_reset_interval == 0)


def pad_to_capacity(raw: Dict[str, torch.Tensor], capacity: int
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Pad raw (pre-activation) parameters to ``capacity`` rows.

    Returns (padded raw, alive mask). Dead rows are parked at tiny opacity
    and scale with identity quaternions."""
    n = raw["means"].shape[0]
    if n > capacity:
        raise ValueError(f"{n} splats exceed densify capacity {capacity}")
    pad = capacity - n

    def pad_rows(x, fill):
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    quat_tail = raw["quats"].new_zeros((pad, 4))
    quat_tail[:, 0] = 1.0
    padded = {
        "means": pad_rows(raw["means"], 0.0),
        "log_scales": pad_rows(raw["log_scales"], DEAD_LOG_SCALE),
        "quats": torch.cat([raw["quats"], quat_tail]),
        "logit_opacities": pad_rows(raw["logit_opacities"], DEAD_LOGIT),
        "colors": pad_rows(raw["colors"], 0.0),
    }
    if "sh_rest" in raw:
        padded["sh_rest"] = pad_rows(raw["sh_rest"], 0.0)
    alive = torch.arange(capacity, device=raw["means"].device) < n
    return padded, alive


@_counted
def reset_opacity(raw: Dict[str, torch.Tensor], ceiling: float = 0.01
                  ) -> Dict[str, torch.Tensor]:
    """Clamp every row's opacity to <= ceiling (3DGS's periodic reset).
    Dead rows sit far below any sensible ceiling, so it leaves them be."""
    lo = raw["logit_opacities"]
    cap_logit = inverse_sigmoid(device_.constant((ceiling,), torch.float32, lo.device))
    return dict(raw, logit_opacities=torch.minimum(lo, cap_logit))


def reset_opacity_moments(opt_state: dict, capacity: int) -> dict:
    """Zero both Adam moments of ``logit_opacities`` (3DGS replaces the
    opacity optimizer state after a reset: stale moments would push the
    opacities straight back up). ``count`` passes through."""
    out = {"count": opt_state["count"]}
    for m in ("mu", "nu"):
        out[m] = dict(opt_state[m])
        leaf = out[m].get("logit_opacities")
        if leaf is not None and leaf.ndim >= 1 and leaf.shape[0] == capacity:
            out[m]["logit_opacities"] = torch.zeros_like(leaf)
    return out


def reset_rows(opt_state: dict, changed: torch.Tensor) -> dict:
    """Zero the moment rows of changed slots (new and rewritten splats must
    not inherit stale Adam moments). Moments whose leading axis is the
    capacity are masked; ``count`` passes through."""
    cap = changed.shape[0]
    out = {"count": opt_state["count"]}
    for m in ("mu", "nu"):
        out[m] = {}
        for k, leaf in opt_state[m].items():
            if leaf.ndim >= 1 and leaf.shape[0] == cap:
                mask = changed.reshape((cap,) + (1,) * (leaf.ndim - 1))
                leaf = torch.where(mask, torch.zeros_like(leaf), leaf)
            out[m][k] = leaf
    return out


def _rank_index(mask: torch.Tensor, order_key: torch.Tensor) -> torch.Tensor:
    """Indices of ``mask``'s True rows, smallest float32 ``order_key``
    first, as a full-capacity permutation (rows past the True count are the
    others; callers gate on the count). A stable sort, so ties resolve to
    index order as in the JAX package's ``jnp.argsort(stable=True)``."""
    inf = torch.full((), float("inf"), dtype=torch.float32, device=mask.device)
    return torch.argsort(torch.where(mask, order_key, inf), stable=True)


def split_normals(cap: int, generator: Optional[torch.Generator] = None,
                  device=None, dtype=torch.float32) -> torch.Tensor:
    """The (2, cap, 3) standard normal draws of one densify step: [0] for
    the new split children, [1] for the in-place resample of their
    parents."""
    return torch.randn((2, cap, 3), generator=generator, device=device,
                       dtype=dtype)


@_counted
@torch.no_grad()
def densify_and_prune(
    raw: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    grad_accum: torch.Tensor,
    seen_count: torch.Tensor,
    dc: DensifyConfig,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    iteration: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
           Dict[str, torch.Tensor]]:
    """One adaptive-density step on static shapes, without a host sync.

    Returns (new raw, new alive, changed-row mask, stats of 0-d tensors:
    pruned, cloned, split, alive). ``changed`` rows must have their
    optimizer moments reset (``reset_rows``) and the caller zeroes the
    gradient accumulators. ``normals`` (2, cap, 3) injects the draws
    (``split_normals``); else they come from ``generator`` on the params'
    device. ``iteration`` is the training iteration the event ends, which
    the world-size prune (``dc.big_scale_frac``) needs.
    """
    cap = alive.shape[0]
    dev = raw["means"].device
    opacities = torch.sigmoid(raw["logit_opacities"])
    scales = torch.exp(raw["log_scales"])

    # prune: transparent splats die and their slots free up at once, and
    # past big_prune_after those larger than a share of the scene too
    keep = alive & (opacities >= dc.min_opacity)
    if dc.big_scale_frac > 0.0:
        if iteration is None:
            raise ValueError("the world-size prune (big_scale_frac > 0) needs the iteration")
        if iteration > dc.big_prune_after:
            keep = keep & ~(scales.amax(dim=-1) > dc.big_scale_frac * dc.scene_extent)
    pruned = (alive & ~keep).sum()
    alive = keep

    # candidates: seen at least once, average gradient above threshold
    avg_grad = grad_accum / torch.clamp_min(seen_count, 1.0)
    cand = alive & (seen_count > 0) & (avg_grad > dc.grad_threshold)
    is_split = cand & (scales.amax(dim=-1) > dc.percent_dense * dc.scene_extent)

    # rank-match candidates (strongest first) to free slots (lowest first)
    n_new = torch.minimum(cand.sum(), (~alive).sum())
    src_by_rank = _rank_index(cand, -avg_grad)
    dst_by_rank = _rank_index(
        ~alive, torch.arange(cap, dtype=torch.float32, device=dev))
    use = torch.arange(cap, device=dev) < n_new

    # Both rank arrays are full permutations of the rows (argsorts over all
    # cap rows), so the scatters below never see a duplicate index and give
    # the same result on every run.
    source = torch.arange(cap, device=dev)
    source[dst_by_rank] = torch.where(use, src_by_rank, dst_by_rank)
    is_new = torch.zeros(cap, dtype=torch.bool, device=dev)
    is_new[dst_by_rank] = use
    # split originals whose second sample found a slot are resampled and
    # shrunk in place; candidates left without a slot stay as they are
    orig_resampled = torch.zeros(cap, dtype=torch.bool, device=dev)
    orig_resampled[src_by_rank] = use & is_split[src_by_rank]

    gathered = {k: v[source] for k, v in raw.items()}
    new_is_split = is_split[source]

    # split sampling: x ~ N(mean, R S^2 R^T), scales / split_factor; both
    # children sample the parent's density (Kerbl et al. 5.2)
    if normals is None:
        normals = split_normals(cap, generator, dev, raw["means"].dtype)
    q = gathered["quats"]
    rot = quat_to_rotmat(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
    sig = torch.exp(gathered["log_scales"])

    def offsets(z):
        return torch.einsum("nij,nj->ni", rot, z * sig)

    shrink = torch.log(device_.constant((dc.split_factor,), raw["log_scales"].dtype, dev))

    def choose(base, sampled, mask):
        return torch.where(mask.reshape((cap,) + (1,) * (base.ndim - 1)),
                           sampled, base)

    sampled_log_scales = gathered["log_scales"] - shrink
    out = dict(gathered)
    # new slots: clones copy verbatim, splits take a sample and shrink
    new_split = is_new & new_is_split
    out["means"] = choose(gathered["means"], gathered["means"] + offsets(normals[0]),
                          new_split)
    out["log_scales"] = choose(gathered["log_scales"], sampled_log_scales, new_split)
    # the allocated split originals, each with its own draw
    out["means"] = choose(out["means"], gathered["means"] + offsets(normals[1]),
                          orig_resampled)
    out["log_scales"] = choose(out["log_scales"], sampled_log_scales, orig_resampled)

    # park the rows that are dead after pruning (and not newly allocated)
    dead = ~(alive | is_new)
    out["logit_opacities"] = torch.where(
        dead, torch.full_like(out["logit_opacities"], DEAD_LOGIT),
        out["logit_opacities"])
    out["log_scales"] = choose(out["log_scales"],
                               torch.full_like(out["log_scales"], DEAD_LOG_SCALE), dead)

    alive = alive | is_new
    changed = is_new | orig_resampled | dead
    stats = {"pruned": pruned, "cloned": (is_new & ~new_is_split).sum(),
             "split": new_split.sum(), "alive": alive.sum()}
    return out, alive, changed, stats


@_counted
def accumulate_grad_stats(grad_accum: torch.Tensor, seen_count: torch.Tensor,
                          gnorm: torch.Tensor, alive: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one step's per-splat positional-gradient NORM (the (N,)
    ``densify_grad_norm`` metric of ``trainer.make_train_step``) into the
    statistics. A splat counts as seen when its gradient is nonzero (culled
    and off-screen splats get exactly zero). A batch of one of
    ``accumulate_grad_stats_batched``."""
    if gnorm.ndim != 1:
        raise ValueError(
            f"accumulate_grad_stats takes the per-splat (N,) grad norm, "
            f"got shape {tuple(gnorm.shape)} -- pass the densify_grad_norm metric")
    seen = alive & (gnorm > 0.0)
    return (grad_accum + torch.where(seen, gnorm, torch.zeros_like(gnorm)),
            seen_count + seen)


def accumulate_grad_stats_batched(grad_accum: torch.Tensor, seen_count: torch.Tensor,
                                  gnorm_sum: torch.Tensor, seen_inc: torch.Tensor,
                                  alive: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one batched step in: ``gnorm_sum`` sums the per-view norms over
    the batch and ``seen_inc`` counts the views each splat reached, so a
    batch of B advances the accumulators as B sequential steps do."""
    live = alive.to(torch.float32)
    return grad_accum + gnorm_sum * live, seen_count + seen_inc * live


def _seeded_generator(device, seed: int, step: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    return g


class AdaptiveStep:
    """One iteration of 3DGS's adaptive loop a call, for a caller that feeds
    one view at a time: ``(state, target, *camera bundle) -> (state,
    metrics)``, in ``fit_scene_adaptive``'s order:

    1. the training step with the selection statistic
       (``make_train_step(..., with_grad_norms=True, grad_stat=dc.statistic)``);
    2. its accumulation (``accumulate_grad_stats``, span ``gs.grad_stats``);
    3. on ``dc.densifies_at(iteration)``: ``densify_and_prune``,
       ``reset_rows`` of the changed rows and zeroed accumulators (span
       ``gs.densify``), then ``on_densify(iteration, (raw, alive) before,
       (raw, alive) after, stats)`` where one is set;
    4. on ``dc.resets_opacity_at(iteration)``: the opacity reset and its
       moments (span ``gs.opacity_reset``).

    No host sync. The step owns the densify state: ``alive``,
    ``grad_accum``, ``seen_count``, ``iteration`` (the iteration the next
    call runs) and ``generator`` (the split draws), all set by ``init``
    and free to be set from a checkpoint. While ``on_densify`` runs,
    ``last_event`` holds the event's inputs besides the hook's
    (``grad_accum``, ``seen_count``, ``opt_state``, the generator's
    ``rng_state`` before the draw) and outputs (``changed``,
    ``new_opt_state``); after it, None. ``metrics`` are the training
    step's.
    """

    def __init__(self, cfg, tc, width: int, height: int, dc: DensifyConfig, param_keys,
                 seed: int = 0, first_iteration: int = 0,
                 on_densify: Optional[Callable] = None):
        from openglgaussiansplattingrenderer_tpu_torch.train import trainer

        self.dc, self.seed = dc, seed
        self.step = trainer.make_train_step(cfg, tc, width, height, with_grad_norms=True,
                                            grad_stat=dc.statistic,
                                            param_keys=tuple(param_keys))
        self.optimizer = self.step.optimizer
        self.iteration = first_iteration
        self.on_densify = on_densify
        self.alive = self.grad_accum = self.seen_count = self.generator = None
        self.last_event = None

    def init(self, raw: Dict[str, torch.Tensor]):
        """The training state of raw parameters padded to ``dc.capacity``;
        the live set is their rows, the accumulators zero and the generator
        seeded from (seed, iteration)."""
        padded, self.alive = pad_to_capacity(raw, self.dc.capacity)
        dev = padded["means"].device
        self.grad_accum = torch.zeros(self.dc.capacity, dtype=torch.float32, device=dev)
        self.seen_count = torch.zeros(self.dc.capacity, dtype=torch.float32, device=dev)
        self.generator = _seeded_generator(dev, self.seed, self.iteration)
        return self.step.init(padded)

    def __call__(self, state, target, *bundle):
        from openglgaussiansplattingrenderer_tpu_torch.train import trainer

        i, dc = self.iteration, self.dc
        state, metrics = self.step(state, target, *bundle)
        with span("gs.grad_stats"):
            self.grad_accum, self.seen_count = accumulate_grad_stats(
                self.grad_accum, self.seen_count, metrics["densify_grad_norm"], self.alive)
        if dc.densifies_at(i):
            with span("gs.densify"):
                before = (state.raw, self.alive)
                if self.on_densify is not None:
                    self.last_event = {"grad_accum": self.grad_accum,
                                       "seen_count": self.seen_count,
                                       "opt_state": state.opt_state,
                                       "rng_state": self.generator.get_state()}
                new_raw, self.alive, changed, dstats = densify_and_prune(
                    state.raw, self.alive, self.grad_accum, self.seen_count, dc,
                    generator=self.generator, iteration=i)
                state = trainer.TrainState(new_raw, reset_rows(state.opt_state, changed),
                                           state.step)
                self.grad_accum = torch.zeros_like(self.grad_accum)
                self.seen_count = torch.zeros_like(self.seen_count)
            if self.on_densify is not None:
                self.last_event.update(changed=changed, new_opt_state=state.opt_state)
                self.on_densify(i, before, (state.raw, self.alive), dstats)
                self.last_event = None
        if dc.resets_opacity_at(i):
            with span("gs.opacity_reset"):
                state = trainer.TrainState(
                    reset_opacity(state.raw, dc.opacity_reset_ceiling),
                    reset_opacity_moments(state.opt_state, dc.capacity), state.step)
        self.iteration = i + 1
        return state, metrics


def make_adaptive_step(cfg, tc, width: int, height: int, dc: DensifyConfig, param_keys,
                       seed: int = 0, first_iteration: int = 0,
                       on_densify: Optional[Callable] = None) -> AdaptiveStep:
    """The adaptive training step (``AdaptiveStep``) for render config
    ``cfg``, train config ``tc`` and raw tensors ``param_keys``; its first
    call runs iteration ``first_iteration`` of ``dc``'s schedule, its
    draws come from a generator seeded from (``seed``,
    ``first_iteration``) at ``init``."""
    return AdaptiveStep(cfg, tc, width, height, dc, param_keys, seed, first_iteration,
                        on_densify)


def fit_scene_adaptive(params, targets, cameras, cfg, dc: DensifyConfig,
                       tc=None, width=None, height=None, seed: int = 0,
                       log_every: int = 50, verbose: bool = True,
                       save_every: int = 0, checkpoint_path=None, resume=None,
                       device: torch.device | str = "cuda",
                       on_densify: Optional[Callable] = None):
    """``trainer.fit_scene`` with adaptive density control, on ``device``,
    one ``make_adaptive_step`` call an iteration.

    Starts from ``params`` (activated, any count <= dc.capacity, tensors
    or numpy arrays), densifies and prunes every ``dc.interval`` steps in
    [start_step, stop_step). Returns (activated params at full capacity,
    alive mask, history); history entries are {step, loss, psnr, alive,
    wall_s} at the log steps, the only host syncs (densify counts are
    printed at the next log step). ``on_densify(step, before, after,
    stats)``, when given, is called after each densify step with the
    (raw, alive) pairs around it.

    ``save_every`` / ``checkpoint_path`` / ``resume`` as in
    ``trainer.fit_scene``; checkpoints also carry ``alive``, ``grad_accum``,
    ``seen_count`` and the generator's state (``x_rng_state``), so a
    resumed run replays the uninterrupted one bit for bit. A checkpoint of
    the JAX package's ``fit_scene_adaptive`` resumes too (its raw arrays,
    Adam leaves and densify state); its draws came from a ``jax.random``
    key (``x_rng_key``), so the generator is seeded from (seed, step)
    instead and the later draws are not the JAX run's.
    """
    from openglgaussiansplattingrenderer_tpu_torch import convert
    from openglgaussiansplattingrenderer_tpu_torch.train import trainer

    tc = tc or trainer.TrainConfig()
    device = torch.device(device)
    width = width or trainer.camera_dims(cameras[0])[0]
    height = height or trainer.camera_dims(cameras[0])[1]
    with torch.no_grad():
        raw = trainer.raw_from_params({
            k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.float32, device=device)
            for k, v in params.items() if v is not None})
    pending = []

    def densified(i, before, after, stats):
        pending.append((i, stats))
        if on_densify is not None:
            on_densify(i, before, after, stats)

    step = make_adaptive_step(cfg, tc, width, height, dc, tuple(sorted(raw.keys())),
                              seed, on_densify=densified)
    state = step.init(raw)
    start_step = 0
    if resume:
        r_raw, start_step, extras = trainer.load_checkpoint_full(resume)
        trainer.check_resume_shapes(state.raw, r_raw, resume)
        if "alive" not in extras:
            raise ValueError(
                f"resume checkpoint {resume!r} carries no densify state "
                "(alive/grad_accum/...) -- was it saved from a run "
                "without adaptive density control?")
        if "opt_leaves" in extras:       # written by the JAX package
            state = convert.train_state_from_checkpoint(resume, tc, device)
        else:
            opt = (trainer.restore_opt_state(state.opt_state, extras["opt_state"])
                   if "opt_state" in extras else state.opt_state)
            state = trainer.TrainState(
                {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in r_raw.items()}, opt, start_step)
        step.iteration = start_step
        step.alive = torch.as_tensor(extras["alive"], dtype=torch.bool, device=device)
        step.grad_accum = torch.as_tensor(extras["grad_accum"], dtype=torch.float32,
                                          device=device)
        step.seen_count = torch.as_tensor(extras["seen_count"], dtype=torch.float32,
                                          device=device)
        if "rng_state" in extras:
            step.generator.set_state(torch.as_tensor(extras["rng_state"], dtype=torch.uint8))
        else:
            step.generator = _seeded_generator(device, seed, start_step)
            print(f"resume: {resume} holds a jax.random key, not a torch "
                  f"generator state; draws from here on come from a generator "
                  f"seeded from (seed {seed}, step {start_step}) and are not "
                  "the JAX run's")
        if verbose:
            print(f"resumed {resume} at step {start_step} "
                  f"(alive {int(step.alive.sum())})")

    cam_bundles = trainer.camera_bundles(cameras, device)
    targets = [torch.as_tensor(t if torch.is_tensor(t) else np.array(t, np.float32),
                               dtype=torch.float32, device=device) for t in targets]

    t0 = time.time()
    history = []
    for i in range(start_step, tc.steps):
        j = i % len(targets)
        state, metrics = step(state, targets[j], *cam_bundles[j])
        if verbose and dc.resets_opacity_at(i):
            print(f"step {i}: opacity reset (<= {dc.opacity_reset_ceiling})")

        if i % log_every == 0 or i == tc.steps - 1:
            # float(...) waits for the queued steps, so wall_s is honest
            m = {"loss": float(metrics["loss"]), "psnr": float(metrics["psnr"]),
                 "alive": int(step.alive.sum())}
            history.append({"step": i, **m, "wall_s": round(time.time() - t0, 3)})
            if verbose:
                for s, d in pending:
                    print(f"step {s}: densify { {k: int(v) for k, v in d.items()} }")
                print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                      f"alive {m['alive']}")
            pending = []

        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            trainer.save_checkpoint(
                checkpoint_path, state.raw, step=i + 1, opt_state=state.opt_state,
                alive=step.alive, grad_accum=step.grad_accum, seen_count=step.seen_count,
                rng_state=step.generator.get_state())

    with torch.no_grad():
        return trainer.params_from_raw(state.raw), step.alive, history


def compact_params(params: Dict[str, torch.Tensor], alive) -> Dict[str, np.ndarray]:
    """Host side: drop the dead rows (for PLY export and hand-off)."""
    mask = alive.cpu().numpy() if torch.is_tensor(alive) else np.asarray(alive)
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))[mask]
            for k, v in params.items()}
