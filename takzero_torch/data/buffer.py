"""Target buffer with forced-uses accounting, and reanalyze's position store.

The port's own copy of ``takzero_tpu/data/buffer.py``.  ``TargetBuffer``
holds the reference learner's exploitation and reanalyze buffers
(learn/src/main.rs:78-96, 485-519): each target is used at most
``forced_uses`` times; a batch is drawn by shuffling and draining the tail,
and used targets go back with one use fewer.  ``PositionBuffer`` is
reanalyze's flat store of replay positions.  Both draw from the same numpy
``Generator`` calls as the JAX package, so one seed picks the same items.
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


class PositionBuffer:
    """Flat position store for reanalyze (reanalyze/src/main.rs:38-53),
    keeping the newest ``max_len`` items when that is given."""

    def __init__(self, rng: np.random.Generator, max_len: int | None = None):
        self._rng = rng
        self._items: list = []
        self._max_len = max_len

    def __len__(self) -> int:
        return len(self._items)

    def extend(self, items):
        self._items.extend(items)
        if self._max_len is not None and len(self._items) > self._max_len:
            del self._items[: len(self._items) - self._max_len]

    def sample(self, k: int):
        """``k`` distinct positions (fewer if the buffer is shorter): the
        reference samples without repetition (reanalyze/src/main.rs:150-157),
        so one batch never searches a position twice."""
        k = min(k, len(self._items))
        if k == 0:
            return []
        idx = self._rng.choice(len(self._items), size=k, replace=False)
        return [self._items[i] for i in idx]
