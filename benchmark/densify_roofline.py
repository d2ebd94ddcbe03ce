"""Bytes of the adaptive training step's own work: the selection statistic
and the densify event (``train.densify``), counted from what 3DGS's rule
needs (``reference/densify.py``), not from how torch runs it: each input
read once, each output written once. Neither does float work worth
counting beside its bytes.
"""

from __future__ import annotations

from typing import Tuple


def statistic(rows: int) -> Tuple[float, float]:
    """One step's statistic over ``rows`` capacity rows: the (N, 2)
    gradient of the 2-D shift read (8 B), the live mask read (1 B), both
    accumulators read and written (16 B): 25 B a row."""
    return 25.0 * rows, 0.0


def event(rows: int, changed: int, row_floats: int) -> Tuple[float, float]:
    """One densify event over ``rows`` capacity rows of ``row_floats``
    float32 parameters each, ``changed`` of them rewritten:

    - every row: the selection's inputs read (opacity 4 B, log-scales
      12 B, both accumulators 8 B, the live mask 1 B), the live mask
      written (1 B) and both accumulators zeroed (8 B): 34 B;
    - the rank keys: each of the two rankings (candidates by statistic,
      free rows by index) writes and reads a 4 B key and writes a 4 B row
      index: 24 B a row;
    - every changed row: its source's raw row read and its own written,
      both of its Adam moment rows written: 16 B a parameter float.
    """
    return 58.0 * rows + 16.0 * row_floats * changed, 0.0
