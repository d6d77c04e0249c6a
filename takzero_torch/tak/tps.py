"""Host-side TPS parsing/printing for the port's :class:`TakState`.

The port's own copy of ``takzero_tpu/tak/tps.py`` (TPS, the Tak
Positional System: rows from rank N down to rank 1 separated by '/',
squares separated by ',', ``xK`` for K empties, stacks as colour digit
strings, 1=white and 2=black, bottom to top with an optional trailing S
(wall) or C (cap) for the top piece; then `` {to_move} {move_number}``).

The stack colours live in the port's single int64 ``owner`` lane (bit h =
colour of the piece at height h), not in JAX's two uint32 lanes.
``state_to_tps`` takes one position (fields without a batch dimension);
``tps_fields`` parses one TPS into numpy arrays, which
``data/native_loader.py`` stacks for a whole batch.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .moves import DEFAULT_RESERVES
from .state import TakState


def state_to_tps(n: int, state: TakState) -> str:
    """TPS of one position (every field without a batch dimension)."""
    height = np.asarray(state.height)
    owners = np.asarray(state.owner, dtype=np.int64)
    tops = np.asarray(state.tops)

    rows = []
    for r in range(n - 1, -1, -1):
        squares = []
        for c in range(n):
            sq = r * n + c
            h = int(height[sq])
            if h == 0:
                squares.append("x")
                continue
            bitsv = int(owners[sq])
            text = "".join("2" if bitsv >> i & 1 else "1" for i in range(h))
            top = int(tops[sq])
            if top == 2:
                text += "S"
            elif top == 3:
                text += "C"
            squares.append(text)
        # Collapse runs of empties into xK.
        collapsed: list[str] = []
        run = 0
        for s in squares + [None]:
            if s == "x":
                run += 1
                continue
            if run:
                collapsed.append("x" if run == 1 else f"x{run}")
                run = 0
            if s is not None:
                collapsed.append(s)
        rows.append(",".join(collapsed))

    to_move = int(state.to_move) + 1
    move_number = int(state.ply) // 2 + 1
    return f"{'/'.join(rows)} {to_move} {move_number}"


def states_to_tps(n: int, states: TakState) -> list[str]:
    """The TPS of each position of a batched CPU state."""
    fields = [np.asarray(x) for x in states]
    return [state_to_tps(n, TakState(*(f[i] for f in fields))) for i in range(states.ply.shape[0])]


_SQUARE_RE = re.compile(r"x(\d?)|([12]+)([SC]?)")


def tps_fields(n: int, tps: str) -> dict:
    """Parse one TPS into numpy fields (``TakState``'s names, no batch dim).

    Raises ``ValueError`` on a malformed TPS.
    """
    board_part, to_move_s, move_number_s = tps.strip().rsplit(" ", 2)
    to_move = int(to_move_s) - 1
    ply = (int(move_number_s) - 1) * 2 + to_move

    s = n * n
    height = np.zeros(s, np.int32)
    owner = np.zeros(s, np.int64)
    tops = np.zeros(s, np.int32)
    stones, caps = DEFAULT_RESERVES[n]
    reserves = np.array([[stones, caps], [stones, caps]], np.int32)

    rows = board_part.split("/")
    if len(rows) != n:
        raise ValueError(f"expected {n} rows in TPS, got {len(rows)}")
    for i, row in enumerate(rows):
        r = n - 1 - i
        c = 0
        for token in row.split(","):
            m = _SQUARE_RE.fullmatch(token)
            if not m:
                raise ValueError(f"bad TPS square {token!r}")
            if m.group(1) is not None and token.startswith("x"):
                c += int(m.group(1) or 1)
                continue
            digits, mod = m.group(2), m.group(3)
            if c >= n or len(digits) > 64:
                raise ValueError(f"bad TPS row {row!r}")
            sq = r * n + c
            height[sq] = len(digits)
            val = 0
            for k, d in enumerate(digits):
                color = int(d) - 1
                val |= color << k
                reserves[color, 0] -= 1
            if mod == "C":
                # Top piece is a cap: it came from the cap reserve.
                top_color = int(digits[-1]) - 1
                reserves[top_color, 0] += 1
                reserves[top_color, 1] -= 1
                tops[sq] = 3
            elif mod == "S":
                tops[sq] = 2
            else:
                tops[sq] = 1
            owner[sq] = val - (1 << 64) if val >> 63 else val  # int64 bit pattern
            c += 1
        if c != n:
            raise ValueError(f"row {row!r} has {c} squares, expected {n}")

    return dict(
        height=height,
        owner=owner,
        tops=tops,
        reserves=reserves,
        to_move=np.int32(to_move),
        ply=np.int32(ply),
        reversible=np.int32(0),
    )


def tps_to_state(n: int, tps: str) -> TakState:
    """One position (tensors without a batch dimension) from its TPS."""
    return TakState(**{k: torch.as_tensor(v) for k, v in tps_fields(n, tps).items()})
