"""The arithmetic of the end-to-end metrics.

The rate is the one of ``takzero_torch/bench.py`` (``(budget + 1) *
batch`` simulations a move: the root's initialising simulation counts),
taken over every whole move of the window and the window's whole time."""

from __future__ import annotations

import math


def selfplay_sims(budget: int, batch: int, moves: int) -> int:
    """Simulations of ``moves`` whole moves of ``batch`` games."""
    return (budget + 1) * batch * moves


def rate(work: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    sample with at least ``q`` percent of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]
