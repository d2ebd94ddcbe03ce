"""The ``train-densify`` kind: 3DGS's densification phase, one adaptive
training step a unit.

Each unit is one call of the step that the port's
``train.densify.make_adaptive_step`` returns (the training step with the
screen-space statistic, its accumulation, a densify event every
``densify.interval``-th iteration; the port's normal path, as
``fit_scene_adaptive`` runs it), fed as ``train`` feeds its step: the next
view of a seeded shuffle of the training views, dispatched back to back,
the loss read every ``readback_every`` steps and at the window's end. The
first call runs 3DGS's iteration ``first_iteration``; the splats alive
then are the configuration's scene at ``start_alive_frac`` of the
capacity (``splats``), the other rows parked.

Set-up runs ``checked_steps`` steps (checked against
``reference/train.py`` as ``train`` checks them, and the first step's
statistic against ``reference/densify.py``), then steps through the
first densify event, whose inputs and outputs it keeps on the host for
the reference, and pins the record capacity by the port's
``autotune_capacity`` over every training view of the scene as that event
left it. A step whose frame dropped records (``overflow``) or whose loss
is not finite is failed.

Compared, beside the three numbers of ``check.step_numbers``:
``stat_gap`` (the first step's statistic, the norm of the difference over
the reference's), ``alive_gap`` and ``changed_gap`` (rows whose live or
changed flag differs after the reference's event on the kept inputs:
exact) and ``densify_gap`` (the worst tensor's largest gap over its
largest value, of the raw parameters and Adam's moments after it).
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from benchmark.cell import Cell

TINY_MIX = {"first_iteration": 3095, "readback_every": 2, "warmup_steps": 1}


def _train_config(tr, cfg):
    lr = cfg["train"]["lr"]
    return tr.TrainConfig(lr_means=lr["means"], lr_scales=lr["log_scales"],
                          lr_quats=lr["quats"], lr_opacities=lr["logit_opacities"],
                          lr_colors=lr["colors"], lambda_dssim=cfg["train"]["lambda_dssim"])


def _densify_config(dn, cfg, extent):
    d = cfg["densify"]
    return dn.DensifyConfig(
        capacity=int(cfg["splats"]), grad_threshold=float(d["grad_threshold"]),
        statistic=d["statistic"], percent_dense=float(d["percent_dense"]),
        scene_extent=extent, min_opacity=float(d["min_opacity"]),
        split_factor=float(d["split_factor"]), start_step=int(d["from_iteration"]),
        stop_step=int(d["until_iteration"]), interval=int(d["interval"]),
        opacity_reset_interval=int(d["opacity_reset_interval"]),
        opacity_reset_ceiling=float(d["opacity_reset_ceiling"]),
        big_scale_frac=float(d["big_scale_frac"]), big_prune_after=int(d["big_prune_after"]))


def start_scene(cfg, mix, seed, device, base):
    """The live splats of the first iteration, in raw form."""
    from benchmark import scenes

    n = int(round(float(mix["start_alive_frac"]) * int(cfg["splats"])))
    return scenes.raw_scene(dict(cfg, splats=n), seed, device, base)


def first_event(cfg, mix) -> int:
    """The first densify iteration after the checked steps."""
    d = cfg["densify"]
    i = int(mix["first_iteration"]) + int(mix["checked_steps"])
    i += -i % int(d["interval"])
    if not int(d["from_iteration"]) <= i < int(d["until_iteration"]):
        raise ValueError(f"no densify event at iteration {i}")
    return i


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu") if torch.is_tensor(tree) else tree


def _device(tree, dev):
    if isinstance(tree, dict):
        return {k: _device(v, dev) for k, v in tree.items()}
    return tree.to(dev) if torch.is_tensor(tree) else tree


def _worst_gap(prog: dict, ref: dict) -> float:
    """The worst tensor's largest gap over its largest value."""
    out = 0.0
    for k, r in ref.items():
        p = prog[k].to(r.device)
        out = max(out, float((p - r).abs().max()) / max(float(r.abs().max()), 1e-30))
    return out


class TrainDensify(Cell):
    unit_name = "step"

    def setup(self):
        from benchmark import check, scenes
        from benchmark.reference import densify as rd
        from benchmark.reference.train import params_from_raw

        cfg, mix, p = self.cfg, self.mix, self.program
        dn, tr = p.module("train.densify"), p.module("train.trainer")
        self.make = dn.make_adaptive_step
        raw0 = start_scene(cfg, mix, self.seed, self.dev, self.base)
        self.keys = list(raw0)
        self.views = scenes.training_views(cfg)
        self.extent = rd.scene_extent(self.views)
        self.targets = scenes.targets(cfg, len(self.views), self.seed, self.dev)
        self.sync()
        self.stamp(f"scene of {raw0['means'].shape[0]} splats and targets")
        self.margin = float(mix["capacity_margin"])
        self.rcfg = p.autotune(scenes.activated(raw0), self.views, p.render_config(cfg), cfg,
                               self.margin)
        self.stamp(f"capacity {self.rcfg.capacity_records}")
        self.tc = _train_config(tr, cfg)
        self.dc = _densify_config(dn, cfg, self.extent)
        self.step = self.make(self.rcfg, self.tc, int(cfg["width"]), int(cfg["height"]),
                              self.dc, tuple(self.keys), self.seed,
                              int(mix["first_iteration"]))
        for k in self.keys:
            got = self.step.optimizer.learning_rate(k, 0)
            want = float(cfg["train"]["lr"][k])
            if abs(got - want) > 1e-12 * abs(want):
                raise ValueError(f"the program steps {k} at {got}, the configuration states {want}")
        self.bundles = p.bundles(self.views, self.dev)
        self.rng, self.stack = random.Random(self.seed), []
        self.readback = int(mix["readback_every"])
        self.state = self.step.init(raw0)
        del raw0
        start = {k: v.clone() for k, v in self.state.raw.items()}
        self.checked, self.prog_losses = [], []
        for j in range(int(mix["checked_steps"])):
            v = self.next_view()
            self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
            self.checked.append(v)
            self.prog_losses.append(float(m["loss"]))
            if j == 0:   # Adam's first moment after one step is (1 - b1) g
                mu = p.moments(self.state)
                self.prog_grad = {k: check.norm(mu[k]) / 0.1 for k in self.keys}
                self.prog_stat = m["densify_grad_norm"].clone()
        self.prog_change = {k: check.norm(self.state.raw[k] - start[k]) for k in self.keys}
        del start
        self.stamp("checked steps")

        self.event_at = first_event(cfg, mix)
        self.kept_event = None
        self.step.on_densify = self._keep_event
        while self.step.iteration <= self.event_at:
            v = self.next_view()
            self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
        float(m["loss"])
        if self.kept_event is None:
            raise RuntimeError(f"no densify event at iteration {self.event_at}")
        self.stamp(f"event at iteration {self.event_at}: " + ", ".join(
            f"{k} {v}" for k, v in self.kept_event["stats"].items()))

        with torch.no_grad():
            params = params_from_raw(self.state.raw)
            self.rcfg = p.autotune(params, self.views, p.render_config(cfg), cfg, self.margin)
            del params
        old = self.step
        self.step = self.make(self.rcfg, self.tc, int(cfg["width"]), int(cfg["height"]),
                              self.dc, tuple(self.keys), self.seed, old.iteration)
        for name in ("alive", "grad_accum", "seen_count", "generator"):
            setattr(self.step, name, getattr(old, name))
        del old
        self.stamp(f"capacity {self.rcfg.capacity_records} after the event")
        for _ in range(int(mix["warmup_steps"])):
            v = self.next_view()
            self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
        float(m["loss"])
        self.sync()
        self.traced_events = []
        self.step.on_densify = self._count_event
        self.losses, self.overflows, self.done = [], [], []

    def _keep_event(self, i, before, after, stats):
        """The first event's inputs and outputs, on the host."""
        ev = self.step.last_event
        self.kept_event = {
            "iteration": i, "raw": _host(before[0]), "alive": _host(before[1]),
            "grad_accum": _host(ev["grad_accum"]), "seen_count": _host(ev["seen_count"]),
            "mu": _host(ev["opt_state"]["mu"]), "nu": _host(ev["opt_state"]["nu"]),
            "rng_state": ev["rng_state"].clone(),
            "out": {"raw": _host(after[0]), "alive": _host(after[1]),
                    "changed": _host(ev["changed"]), "mu": _host(ev["new_opt_state"]["mu"]),
                    "nu": _host(ev["new_opt_state"]["nu"])},
            "stats": {k: int(v) for k, v in stats.items()}}
        self.step.on_densify = None

    def _count_event(self, i, before, after, stats):
        """An event inside the traced steps: its live and changed counts,
        read after the window."""
        self.traced_events.append((stats["alive"], self.step.last_event["changed"].sum()))

    def next_view(self) -> int:
        if not self.stack:
            self.stack = list(range(len(self.views)))
            self.rng.shuffle(self.stack)
        return self.stack.pop()

    def unit(self, i: int, timed: bool):
        if timed and self.step.on_densify is not None:
            self.step.on_densify = None
        v = self.next_view()
        t0 = time.perf_counter()
        self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
        t1 = time.perf_counter()
        if timed:
            self.host.append(t1 - t0)
        self.losses.append(m["loss"])
        self.overflows.append(m["overflow"])
        self.done.append(v)
        if len(self.losses) % self.readback == 0:
            float(m["loss"])

    def finish(self):
        self.sync()
        if self.losses:
            float(self.losses[-1])

    def tally(self, n: int, seconds: float) -> dict:
        torch = self.torch
        if not self.losses:
            return {"failed": 0, "values": {"train_steps_per_s": n / seconds}}
        ls = torch.stack(self.losses).cpu()
        over = torch.stack([o.to(torch.int64) for o in self.overflows]).cpu()
        bad = ~torch.isfinite(ls) | (over > 0)
        return {"failed": int(bad.sum()), "values": {"train_steps_per_s": n / seconds}}

    def unit_shapes(self, first: int, count: int):
        """Each traced step's shapes (as ``train``'s, ``splats`` the
        capacity), with the live and changed rows of the traced event."""
        from benchmark.reference.train import params_from_raw

        torch = self.torch
        alive = changed = 0
        if self.traced_events:
            alive, changed = (int(x) for x in self.traced_events[-1])
        with torch.no_grad():
            params = params_from_raw(self.state.raw)
            seen = {}
            for v in self.done[first:first + count]:
                if v not in seen:
                    _, st = self.program.render(params, self.views[v], self.rcfg, self.cfg)
                    seen[v] = (int(st["num_records"]), int(st["binned_records"]))
        elements = sum(int(t.numel()) for t in self.state.raw.values())
        return [dict(self.shapes(*seen[v]), adam_elements=elements, alive=alive,
                     changed=changed) for v in self.done[first:first + count]]

    def free(self):
        kept = {"views": [(self.targets[v].clone(), self.views[v]) for v in self.checked],
                "stat": self.prog_stat, "event": self.kept_event}
        for name in ("state", "step", "bundles", "targets", "losses", "overflows", "rcfg",
                     "kept_event", "prog_stat"):
            setattr(self, name, None)
        return kept

    def reference(self, kept):
        from benchmark import check
        from benchmark.reference import densify as rd
        from benchmark.reference import render as rr
        from benchmark.reference import train as rt

        cfg, dev = self.cfg, self.dev
        raw0 = rd.pad(start_scene(cfg, self.mix, self.seed, dev, self.base), int(cfg["splats"]))
        views = kept["views"]
        losses, first, change = rt.run_steps(raw0, views, cfg, len(views))
        out = check.step_numbers(self.prog_losses, self.prog_grad, self.prog_change, losses,
                                 {k: check.norm(first[k]) for k in self.keys},
                                 {k: check.norm(change[k]) for k in self.keys})
        del first, change
        target, cam = views[0]
        stat = rd.screen_statistic(raw0, target, cam, rr.frame_of(cfg),
                                   float(cfg["train"]["lambda_dssim"]))
        out["stat_gap"] = check.norm(kept["stat"].to(dev) - stat) / check.norm(stat)
        del raw0, stat
        out.update(event_numbers(kept["event"], cfg, self.extent, dev))
        return out


CELL = TrainDensify


def event_numbers(ev, cfg, extent, dev, prec=None) -> dict:
    """The reference's event on the kept inputs against the kept outputs."""
    from benchmark.reference import densify as rd
    from benchmark.reference import render as rr

    g = torch.Generator(device=dev)
    g.set_state(ev["rng_state"])
    ref = rd.event(_device(ev["raw"], dev), ev["alive"].to(dev), ev["grad_accum"].to(dev),
                   ev["seen_count"].to(dev), _device(ev["mu"], dev), _device(ev["nu"], dev),
                   g, cfg["densify"], extent, ev["iteration"], prec or rr.FP32)
    prog = ev["out"]
    gap = max(_worst_gap(prog[m], ref[m]) for m in ("raw", "mu", "nu"))
    return {"alive_gap": float((prog["alive"].to(dev) != ref["alive"]).sum()),
            "changed_gap": float((prog["changed"].to(dev) != ref["changed"]).sum()),
            "densify_gap": gap}


def ref_bf16(cfg, mix, seed, device, base):
    """The reference in bfloat16 against itself in float32: the checked
    steps and the statistic from the padded start, and an event on it with
    the first view's statistic accumulated and the first step's moments."""
    from benchmark import check, scenes
    from benchmark.reference import densify as rd
    from benchmark.reference import render as rr
    from benchmark.reference import train as rt

    low = rr.Precision(torch.bfloat16)
    raw0 = rd.pad(start_scene(cfg, mix, seed, device, base), int(cfg["splats"]))
    views = scenes.training_views(cfg)
    rng, stack, chosen = random.Random(seed), [], []
    for _ in range(int(mix["checked_steps"])):
        if not stack:
            stack = list(range(len(views)))
            rng.shuffle(stack)
        chosen.append(stack.pop())
    tg = scenes.targets(cfg, len(views), seed, device)
    kept = [(tg[v].clone(), views[v]) for v in chosen]
    del tg
    lo = rt.run_steps(raw0, kept, cfg, len(kept), low)
    hi = rt.run_steps(raw0, kept, cfg, len(kept))
    norms = lambda d: {k: check.norm(v) for k, v in d.items()}  # noqa: E731
    out = check.step_numbers(lo[0], norms(lo[1]), norms(lo[2]), hi[0], norms(hi[1]),
                             norms(hi[2]))
    fr, lam = rr.frame_of(cfg), float(cfg["train"]["lambda_dssim"])
    stat = rd.screen_statistic(raw0, kept[0][0], kept[0][1], fr, lam)
    stat_lo = rd.screen_statistic(raw0, kept[0][0], kept[0][1], fr, lam, low)
    out["stat_gap"] = check.norm(stat_lo - stat) / check.norm(stat)
    n = int(round(float(mix["start_alive_frac"]) * int(cfg["splats"])))
    alive = torch.arange(int(cfg["splats"]), device=device) < n
    grad = hi[1]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    ev = {"iteration": first_event(cfg, mix), "raw": raw0, "alive": alive,
          "grad_accum": stat, "seen_count": (stat > 0).to(torch.float32),
          "mu": {k: 0.1 * v for k, v in grad.items()},
          "nu": {k: 0.001 * v * v for k, v in grad.items()}, "rng_state": g.get_state()}
    extent = rd.scene_extent(views)
    ref = rd.event(raw0, alive, ev["grad_accum"], ev["seen_count"], ev["mu"], ev["nu"],
                   g, cfg["densify"], extent, ev["iteration"])
    ev["out"] = {"raw": ref["raw"], "alive": ref["alive"], "changed": ref["changed"],
                 "mu": ref["mu"], "nu": ref["nu"]}
    out.update(event_numbers(ev, cfg, extent, device, low))
    return out


class _Patched:
    """An adaptive step whose calls run with one of the port's densify
    functions replaced (``fault``); every attribute is the step's."""

    def __init__(self, step, densify, fault):
        object.__setattr__(self, "_step", step)
        object.__setattr__(self, "_densify", densify)
        object.__setattr__(self, "_fault", fault)

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __setattr__(self, name, value):
        setattr(self._step, name, value)

    def __call__(self, *args):
        dn, name = self._densify, {"no_densify": "densify_and_prune",
                                   "stale_moments": "reset_rows"}[self._fault]
        whole = getattr(dn, name)

        def unchanged(raw, alive, *a, **kw):
            zero = alive.sum() * 0
            return (dict(raw), alive.clone(), torch.zeros_like(alive),
                    {"pruned": zero, "cloned": zero, "split": zero, "alive": alive.sum()})

        setattr(dn, name, unchanged if name == "densify_and_prune" else
                (lambda opt_state, changed: opt_state))
        try:
            return self._step(*args)
        finally:
            setattr(dn, name, whole)


class _FaultyDensify:
    def __init__(self, densify, fault):
        self._densify, self._fault = densify, fault

    def __getattr__(self, name):
        return getattr(self._densify, name)

    def make_adaptive_step(self, rcfg, tc, width, height, dc, keys, seed, first_iteration=0):
        if self._fault == "world_stat":
            return self._densify.make_adaptive_step(
                rcfg, tc, width, height, dataclasses.replace(dc, statistic="world"), keys,
                seed, first_iteration)
        step = self._densify.make_adaptive_step(rcfg, tc, width, height, dc, keys, seed,
                                                first_iteration)
        return _Patched(step, self._densify, self._fault)


class _Faulty:
    def __init__(self, program, fault):
        self._program, self._fault = program, fault

    def __getattr__(self, name):
        return getattr(self._program, name)

    def module(self, name):
        mod = self._program.module(name)
        return _FaultyDensify(mod, self._fault) if name == "train.densify" else mod


FAULTS = ("no_densify", "world_stat", "stale_moments")


def faulty(program, mode):
    """The program with a fault in its adaptive step: ``no_densify`` (the
    event returns its inputs), ``world_stat`` (the statistic from dL /
    d means) or ``stale_moments`` (``reset_rows`` skipped)."""
    if mode not in FAULTS:
        raise ValueError(f"unknown fault {mode!r} of train-densify")
    return _Faulty(program, mode)
