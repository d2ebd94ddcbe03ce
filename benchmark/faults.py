"""Faults planted under the timed path, to show that ``correct`` catches
them, and the program's own lower-precision paths, the controls.

``Faulty(program, fault)`` stands in for ``benchmark.sut`` with one fault:

- ``unchanged``: the training step returns the state it was given;
- ``half_batch``: the loss is taken over the first half of the image's
  rows, the mean over those alone;
- ``altered``: the answer is altered where it is produced: one pixel of
  the frame, or the step's loss (by 1%);
- ``bwd_bf16`` (control, training): the program's bf16 cotangent mode
  (``records.BWD_COT_PACK = "bf16"``) switched on;
- ``q16`` (control, frames at 512 tiles or fewer): the program's q16
  record payload (``sort_payload="q16"`` on the packed key).

A single card has no exchange between chips, so that fault has no form
here.
"""

from __future__ import annotations

import contextlib
import importlib

FAULTS = ("unchanged", "half_batch", "altered")
CONTROLS = ("bwd_bf16", "q16")


class Faulty:
    def __init__(self, program, fault: str):
        if fault not in FAULTS + CONTROLS:
            raise ValueError(f"unknown fault {fault!r}")
        self.base, self.fault = program, fault

    def __getattr__(self, name):
        return getattr(self.base, name)

    def render_config(self, cfg, **over):
        if self.fault == "q16":
            over = dict(over, depth_key="packed", sort_payload="q16")
        return self.base.render_config(cfg, **over)

    def render(self, params, cam, rcfg, cfg):
        img, st = self.base.render(params, cam, rcfg, cfg)
        if self.fault == "altered":
            img = img.clone()
            img[img.shape[0] // 2, img.shape[1] // 2, 0] += 0.25
        return img, st

    def make_step(self, cfg, rcfg, keys):
        step = self.base.make_step(cfg, rcfg, keys)
        fault = self.fault

        def run(state, target, *cam):
            with self.patched():
                new, m = step(state, target, *cam)
            if fault == "unchanged":
                return state, m
            if fault == "altered":
                m = dict(m, loss=m["loss"] * 1.01)
            return new, m

        run.init = step.init
        run.optimizer = step.optimizer
        return run

    @contextlib.contextmanager
    def patched(self):
        """The program's modules as the fault needs them, restored after."""
        pkg = self.base.PROGRAM
        if self.fault == "half_batch":
            losses = importlib.import_module(pkg + ".train.losses")
            whole = losses.gs_loss

            def half(pred, target, lam):
                h = pred.shape[-3] // 2
                return whole(pred[..., :h, :, :], target[..., :h, :, :], lam)

            losses.gs_loss = half
            try:
                yield
            finally:
                losses.gs_loss = whole
        elif self.fault == "bwd_bf16":
            records = importlib.import_module(pkg + ".ops.kernels.records")
            was = records.BWD_COT_PACK
            records.BWD_COT_PACK = "bf16"
            try:
                yield
            finally:
                records.BWD_COT_PACK = was
        else:
            yield
