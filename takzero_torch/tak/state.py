"""Batch-first Tak board state as torch tensors.

Counterpart of ``takzero_tpu/tak/state.py`` (and of ``tak/bits.py``).  The
JAX state splits the 64-bit stack colour field into two uint32 lanes
(``owner_lo``/``owner_hi``) because TPUs lack fast 64-bit integers.  torch's
CPU build has no uint32 shifts, so the port keeps ONE int64 ``owner`` per
square: bit ``h`` is the colour (0 white, 1 black) of the piece at height
``h``.  int64 right shifts sign-extend, so every extraction masks after the
shift (:func:`get_bit`, :func:`extract_bits`); :func:`split_owner` and
:func:`join_owner` convert to and from the JAX lane pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .moves import DEFAULT_RESERVES

_LO32 = 0xFFFFFFFF


class TakState(NamedTuple):
    """Leading batch dims ``[...]`` on every field (``[B]`` or ``[B, M]``)."""

    height: torch.Tensor  # int32[..., S]
    owner: torch.Tensor  # int64[..., S] colour bits, bit h = height h
    tops: torch.Tensor  # int32[..., S] 0 empty / 1 flat / 2 wall / 3 cap
    reserves: torch.Tensor  # int32[..., 2, 2] [player][0=stones, 1=caps]
    to_move: torch.Tensor  # int32[...] 0 white / 1 black
    ply: torch.Tensor  # int32[...]
    reversible: torch.Tensor  # int32[...] consecutive non-crush spreads

    def map(self, fn) -> "TakState":
        return TakState(*(fn(x) for x in self))


def initial_state_batch(n: int, batch: int, device="cpu") -> TakState:
    s = n * n
    stones, caps = DEFAULT_RESERVES[n]
    zi = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return TakState(
        height=zi(batch, s),
        owner=torch.zeros((batch, s), dtype=torch.int64, device=device),
        tops=zi(batch, s),
        reserves=torch.tensor(
            [[stones, caps], [stones, caps]], dtype=torch.int32, device=device
        ).expand(batch, 2, 2).clone(),
        to_move=zi(batch),
        ply=zi(batch),
        reversible=zi(batch),
    )


def where_state(mask: torch.Tensor, a: TakState, b: TakState) -> TakState:
    """Per-lane select: ``a`` where ``mask`` ([B] bool) else ``b``."""

    def pick(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return TakState(*(pick(x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# 64-bit colour-field helpers (the port of tak/bits.py)
# ---------------------------------------------------------------------------


def get_bit(owner: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit at ``pos`` in [0, 63] (int64 0/1); masks after the shift."""
    return (owner >> pos.to(torch.int64)) & 1


def extract_bits(owner, start, count) -> torch.Tensor:
    """Bits ``[start, start + count)`` as int64 (count <= 32)."""
    mask = (torch.ones_like(owner) << count.to(torch.int64)) - 1
    return (owner >> start.to(torch.int64)) & mask


def low_mask(count: torch.Tensor) -> torch.Tensor:
    """int64 with the low ``count`` bits set, count in [0, 63]."""
    return (torch.ones_like(count, dtype=torch.int64) << count.to(torch.int64)) - 1


def split_owner(owner: torch.Tensor):
    """int64 owner -> (lo, hi) int64 holding the uint32 lane values."""
    return owner & _LO32, (owner >> 32) & _LO32


def join_owner(lo, hi) -> torch.Tensor:
    """(lo, hi) uint32 lane values (any int dtype) -> int64 owner."""
    lo = torch.as_tensor(lo).to(torch.int64) & _LO32
    hi = torch.as_tensor(hi).to(torch.int64) & _LO32
    return lo | (hi << 32)
