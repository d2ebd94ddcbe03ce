"""What every kind of traffic shares, importable without running ``run.py``.

A kind is one way of driving the program: ``orbit`` and ``train`` live in
``run.py``; any other is the file ``kinds/<kind>.py`` (found by name, as
the per-layer readers are), which defines ``CELL``, a subclass of ``Cell``
that holds:

- ``unit_name``: what one unit of work is called ("frame", "step");
- ``setup()``: makes the inputs and the program's state from the seed, on
  the device, and warms up every shape the window will use;
- ``unit(i, timed)``: the ``i``-th frame, step or batch; where ``timed``,
  appends the host's seconds for the call to ``self.host``;
- ``finish()``: waits until the device has done every unit;
- ``tally(n, seconds)``: ``{"failed": int, "values": {metric: value}}``,
  the end-to-end metrics of ``n`` units in ``seconds``;
- ``unit_shapes(first, count)``: a dict of shapes for each traced unit,
  which the per-layer readers take (``Cell.shapes`` gives the frame's);
- ``free()``: drops the program's state and returns what the reference
  needs (the answers to judge, the inputs it works them out from);
- ``reference(kept)``: ``{number: value}``, each compared with the limit
  of that name in ``limits/<cell>.json``.

``run.run_cell`` makes it with the benchmark's directory ``base``, where
a scene generator's file is looked for (``scenes.raw_scene(cfg, seed,
device, self.base)``), and the process's start ``t0``, from which
``stamp`` times each set-up step.

A kind reaches the program only through ``self.program``: ``benchmark.sut``
(``program.module("train.densify")`` gives a submodule of the port by its
dotted name) or a stand-in with a fault planted. Its plain reference may be
a file of its own under ``reference/``. The kind's file may also define
``ref_bf16(cfg, mix, seed, device, base)`` (the reference in a lower
precision against itself, which ``calibrate.py`` reads as the control),
``faulty(program, mode)`` (the program with a fault or a lower-precision
path of the kind's own, for ``calibrate.py``'s modes that ``faults.py``
does not name) and ``TINY_MIX`` (the mix's keys at the size of the CPU
tests).
"""

from __future__ import annotations

import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the nearest ranks."""
    v = sorted(values)
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


class Cell:
    """What the kinds of traffic share: the device, the clock, the
    per-unit shapes the rooflines read, the host's enqueue spans."""

    unit_name = "unit"

    def __init__(self, cfg, mix, seed, device, program, base, t0):
        import torch

        self.torch = torch
        self.cfg, self.mix, self.seed, self.dev, self.program = cfg, mix, seed, device, program
        self.base, self.t0 = base, t0
        self.cuda = device.type == "cuda"
        self.host = []

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def stamp(self, what: str) -> None:
        """A set-up step's time since the process started (``t0``)."""
        log(f"setup: {what} at {time.perf_counter() - self.t0:.3f} s")

    def shapes(self, num_records, binned) -> dict:
        from benchmark.reference.render import frame_of

        fr = frame_of(self.cfg)
        return {"splats": int(self.cfg["splats"]), "sh_degree": int(self.cfg["sh_degree"]),
                "records": int(num_records), "binned": int(binned),
                "pixels": fr.tiles * fr.pixels_per_tile,
                "image_pixels": fr.width * fr.height}
