"""Device-resident novelty bitset: query only (this slice's path).

Counterpart of ``takzero_tpu/ops/bitset.py``.  The uint32 words are held
as int32 tensors with the same bit pattern (torch lacks uint32 shifts);
bit indices are int64 values in ``[0, 2**bits)``.  ``bitset_set`` needs a
scatter-OR and comes with the learner slice.
"""

from __future__ import annotations

import torch


def bitset_init(bits: int, device="cpu") -> torch.Tensor:
    assert bits >= 5
    return torch.zeros((1 << (bits - 5),), dtype=torch.int32, device=device)


def bitset_query(bitset: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bool[K]: is bit ``idx`` set."""
    idx = idx.to(torch.int64)
    word = bitset[idx >> 5]
    return ((word >> (idx & 31).to(torch.int32)) & 1) != 0
