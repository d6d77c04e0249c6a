"""Board symmetries (D4) for states and action indices.

The port's own copy of ``takzero_tpu/tak/symmetry.py`` (plain numpy
tables; the port never imports the JAX package): symmetry ``t = k + 4*m``
applies ``rot90^k`` then ``mirror^m`` where rot90(r, c) = (c, n-1-r) and
mirror(r, c) = (r, n-1-c).  Identity is t=0.  Placement channels keep
their channel under a symmetry; spread directions are remapped by
transforming the direction vector; drop patterns are unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .moves import DIR_DELTAS, action_space
from .state import TakState


def transform_rc(t: int, r: int, c: int, n: int) -> tuple[int, int]:
    for _ in range(t & 3):
        r, c = c, n - 1 - r
    if t >= 4:
        c = n - 1 - c
    return r, c


@functools.lru_cache(maxsize=None)
def square_maps(n: int) -> np.ndarray:
    """[8, S] array: new square index of old square sq under symmetry t."""
    out = np.zeros((8, n * n), np.int32)
    for t in range(8):
        for r in range(n):
            for c in range(n):
                rr, cc = transform_rc(t, r, c, n)
                out[t, r * n + c] = rr * n + cc
    return out


@functools.lru_cache(maxsize=None)
def direction_maps(n: int) -> np.ndarray:
    """[8, 4]: new direction id of old direction under symmetry t."""
    out = np.zeros((8, 4), np.int32)
    deltas = [tuple(d) for d in DIR_DELTAS.tolist()]
    for t in range(8):
        for d, (dr, dc) in enumerate(deltas):
            # Transform two points and take the difference.
            r0, c0 = transform_rc(t, 0, 0, 3)
            r1, c1 = transform_rc(t, dr, dc, 3)
            out[t, d] = deltas.index((r1 - r0, c1 - c0))
    return out


@functools.lru_cache(maxsize=None)
def action_maps(n: int) -> np.ndarray:
    """[8, A]: new action index of old action under symmetry t."""
    sp = action_space(n)
    s = n * n
    sqm = square_maps(n)
    dirm = direction_maps(n)
    out = np.zeros((8, sp.num_actions), np.int32)
    for t in range(8):
        for ch in range(sp.num_channels):
            if ch < 3:
                new_ch = ch
            else:
                si = ch - 3
                nd = int(dirm[t, int(sp.spread_dir[si])])
                new_ch = 3 + nd * sp.num_patterns + si % sp.num_patterns
            out[t, ch * s : (ch + 1) * s] = new_ch * s + sqm[t]
    return out


def transform_state(n: int, state: TakState, syms: torch.Tensor) -> TakState:
    """Apply symmetry ``syms[b]`` to lane b of a batched state ([B, S] fields)."""
    inv = torch.from_numpy(np.argsort(square_maps(n), axis=1)).to(state.height.device)
    gather = inv[syms.to(inv.device, torch.int64)]  # [B, S]: old square of each new square

    def move(x):
        return x.gather(1, gather)

    return state._replace(height=move(state.height), owner=move(state.owner), tops=move(state.tops))
