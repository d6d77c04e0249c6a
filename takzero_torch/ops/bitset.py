"""Device-resident novelty bitset.

Counterpart of ``takzero_tpu/ops/bitset.py``.  The uint32 words are held
as int32 tensors with the same bit pattern (torch lacks uint32 shifts);
bit indices are int64 values in ``[0, 2**bits)``.
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


def bitset_set(bitset: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Set bits ``idx`` in place; returns ``bitset``.

    JAX's algorithm (torch has no scatter-OR either): sort the indices, drop
    repeats and bits already set, and add each remaining power of two to
    its word with one ``index_add_``.  The added bits of a word are distinct
    and unset, so the sum is the OR and no addition carries or overflows.
    The power of two is built in int32, where ``1 << 31`` is the uint32
    pattern 0x80000000.
    """
    sidx = torch.sort(idx.to(torch.int64)).values
    dup = torch.zeros_like(sidx, dtype=torch.bool)
    dup[1:] = sidx[1:] == sidx[:-1]
    word = sidx >> 5
    bit = (sidx & 31).to(torch.int32)
    val = torch.ones_like(bit) << bit
    already = ((bitset[word] >> bit) & 1) != 0
    add = torch.where(dup | already, torch.zeros_like(val), val)
    return bitset.index_add_(0, word, add)
