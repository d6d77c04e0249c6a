"""Target buffer with forced-uses accounting.

The port's own copy of ``TargetBuffer`` from ``takzero_tpu/data/buffer.py``
(the reference learner's exploitation and reanalyze buffers,
learn/src/main.rs:78-96, 485-519): each target is used at most
``forced_uses`` times; a batch is drawn by shuffling and draining the tail,
and used targets go back with one use fewer.  It draws from the same numpy
``Generator`` calls as the JAX package, so one seed drains the same lines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Entry:
    target: object
    forced_uses: int
    model_steps: int


class TargetBuffer:
    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self._entries: list[Entry] = []

    def __len__(self) -> int:
        return len(self._entries)

    def extend(self, targets, forced_uses: int, model_steps: int):
        self._entries.extend(Entry(t, forced_uses, model_steps) for t in targets)

    def drain_batch(self, size: int):
        """Shuffle, pop ``size`` targets, re-insert those with uses left."""
        if len(self._entries) < size:
            raise ValueError(f"buffer has {len(self._entries)} < {size}")
        self._rng.shuffle(self._entries)
        batch = [self._entries.pop() for _ in range(size)]
        out = [e.target for e in batch]
        for e in batch:
            if e.forced_uses > 1:
                e.forced_uses -= 1
                self._entries.append(e)
        return out
