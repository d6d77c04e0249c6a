"""Static action-space tables for Tak.

The action space mirrors the reference's policy-tensor layout
(reference: takzero/src/network/repr.rs:49-116): action index is
``channel * N*N + row*N + col`` where ``row = rank-1`` (bottom-up) and
``col = file`` (a=0). Channels:

* 0: place flat, 1: place wall, 2: place cap
* ``3 + dir*(2^N-2) + (pattern_mask - 1)``: spread in ``dir`` with drop
  pattern ``pattern_mask``.

Directions: 0 = Up (+rank), 1 = Right (+file), 2 = Down, 3 = Left
(reference: repr.rs:58-67).

Pattern mask encoding (reference: takparse ``Pattern``; derived from the
golden policy test repr.rs:411-499): an N-bit value where, for the drop
sequence ``d_1..d_k``, bit ``N - S_j`` is set for every suffix sum
``S_j = d_j + ... + d_k``.  Hence ``carry = N - lowest_set_bit`` and the
number of set bits equals the number of drop squares ``k``.

All tables are plain numpy host constants.  This is the port's own copy
of ``takzero_tpu/tak/moves.py``: the port never imports the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

# Default reserves (flat stones, capstones) by board size; standard Tak.
DEFAULT_RESERVES = {
    3: (10, 0),
    4: (15, 0),
    5: (21, 1),
    6: (30, 1),
    7: (40, 2),
    8: (50, 2),
}

DIR_DELTAS = np.array([(1, 0), (0, 1), (-1, 0), (0, -1)], dtype=np.int32)
DIR_NAMES = "+>-<"

PIECE_EMPTY, PIECE_FLAT, PIECE_WALL, PIECE_CAP = 0, 1, 2, 3


def decode_pattern(mask: int, n: int) -> list[int]:
    """Decode an N-bit pattern mask into its drop sequence ``[d_1..d_k]``."""
    positions = [p for p in range(n) if mask >> p & 1]
    suffix_sums = [n - p for p in positions]  # descending
    drops = []
    for j, s in enumerate(suffix_sums):
        nxt = suffix_sums[j + 1] if j + 1 < len(suffix_sums) else 0
        drops.append(s - nxt)
    return drops


def encode_pattern(drops: list[int], n: int) -> int:
    """Inverse of :func:`decode_pattern`."""
    mask = 0
    s = 0
    for d in reversed(drops):
        s += d
        mask |= 1 << (n - s)
    return mask


@dataclass(frozen=True)
class ActionSpace:
    """Precomputed per-board-size action tables (numpy, host-side)."""

    n: int
    num_patterns: int
    num_channels: int
    num_squares: int
    num_actions: int
    # Per spread-channel (index si in [0, 4 * num_patterns)):
    spread_dir: np.ndarray  # [4P] int32 direction id
    spread_k: np.ndarray  # [4P] number of drop squares
    spread_carry: np.ndarray  # [4P] pieces picked up
    spread_drops: np.ndarray  # [4P, n] drop counts, zero padded
    spread_pre: np.ndarray  # [4P, n] pieces dropped before square i
    field_hash: int = field(default=0)

    def __hash__(self) -> int:  # the numpy fields are not hashable
        return hash((self.n, self.num_actions))


@functools.lru_cache(maxsize=None)
def action_space(n: int) -> ActionSpace:
    p = 2**n - 2
    dirs, ks, carries = [], [], []
    drops_tbl = np.zeros((4 * p, n), dtype=np.int32)
    pre_tbl = np.zeros((4 * p, n), dtype=np.int32)
    for d in range(4):
        for mask in range(1, p + 1):
            drops = decode_pattern(mask, n)
            si = d * p + (mask - 1)
            dirs.append(d)
            ks.append(len(drops))
            carries.append(sum(drops))
            drops_tbl[si, : len(drops)] = drops
            pre_tbl[si, : len(drops)] = np.cumsum([0] + drops[:-1])
    return ActionSpace(
        n=n,
        num_patterns=p,
        num_channels=3 + 4 * p,
        num_squares=n * n,
        num_actions=(3 + 4 * p) * n * n,
        spread_dir=np.array(dirs, dtype=np.int32),
        spread_k=np.array(ks, dtype=np.int32),
        spread_carry=np.array(carries, dtype=np.int32),
        spread_drops=drops_tbl,
        spread_pre=pre_tbl,
    )


def count_possible_moves(n: int) -> int:
    """Number of geometrically distinct moves (reference: repr.rs:16-34).

    Place channels count 2 per square unless the board size has capstones.
    Spreads require k squares of room in their direction.
    """
    a = action_space(n)
    caps = DEFAULT_RESERVES[n][1] > 0
    total = (3 if caps else 2) * a.num_squares
    for si in range(4 * a.num_patterns):
        k = int(a.spread_k[si])
        total += n * max(0, n - k)  # squares with >= k room in that direction
    return total


# ---------------------------------------------------------------------------
# Host-side move naming (PTN) and index mapping.
# ---------------------------------------------------------------------------


def action_index(n: int, channel: int, row: int, col: int) -> int:
    return channel * n * n + row * n + col


def action_to_ptn(n: int, a: int) -> str:
    """Render an action index as a PTN move string (e.g. ``3c2+12``)."""
    sp = action_space(n)
    ch, sq = divmod(a, sp.num_squares)
    row, col = divmod(sq, n)
    square = f"{chr(ord('a') + col)}{row + 1}"
    if ch == 0:
        return square
    if ch == 1:
        return "S" + square
    if ch == 2:
        return "C" + square
    si = ch - 3
    d = int(sp.spread_dir[si])
    k = int(sp.spread_k[si])
    carry = int(sp.spread_carry[si])
    drops = [int(x) for x in sp.spread_drops[si, :k]]
    s = "" if carry == 1 else str(carry)
    s += square + DIR_NAMES[d]
    if k > 1:  # canonical PTN omits the drop string for single-drop spreads
        s += "".join(str(x) for x in drops)
    return s


def ptn_to_action(n: int, ptn: str) -> int:
    """Parse a PTN move string into an action index."""
    sp = action_space(n)
    ptn = ptn.strip().rstrip("*!?'\"")
    ch: int
    if ptn[0] in "SC":
        ch = 1 if ptn[0] == "S" else 2
        square = ptn[1:3]
        rest = ptn[3:]
        if rest:
            raise ValueError(f"bad placement: {ptn}")
    elif any(c in ptn for c in DIR_NAMES):
        carry = 1
        i = 0
        if ptn[0].isdigit():
            carry = int(ptn[0])
            i = 1
        square = ptn[i : i + 2]
        d = DIR_NAMES.index(ptn[i + 2])
        drop_str = ptn[i + 3 :]
        drops = [int(c) for c in drop_str] if drop_str else [carry]
        if sum(drops) != carry:
            raise ValueError(f"drops {drops} != carry {carry}: {ptn}")
        mask = encode_pattern(drops, n)
        if not 1 <= mask <= sp.num_patterns:
            raise ValueError(f"impossible drop pattern for {n}x{n}: {ptn}")
        ch = 3 + d * sp.num_patterns + (mask - 1)
    else:
        ch = 0
        square = ptn[:2]
        if ptn[2:]:
            raise ValueError(f"bad placement: {ptn}")
    col = ord(square[0]) - ord("a")
    row = int(square[1]) - 1
    if not (0 <= col < n and 0 <= row < n):
        raise ValueError(f"square out of range: {ptn}")
    return action_index(n, ch, row, col)
