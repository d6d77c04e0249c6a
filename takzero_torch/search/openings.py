"""Random opening generation.

Counterpart of ``takzero_tpu/search/openings.py``: two flats on adjacent
corners (a1, aN) or opposite corners (a1, xN), under one of the 8 board
symmetries, then ``random_steps`` uniformly random legal plies.  The draws
come in as tensors: ``sym`` int64[B] in [0, 8), ``pair`` int64[B] in
[0, 2), and for the random plies ``gumbel``, either f32[random_steps, B, A]
or a callable ``ply -> f32[B, A]`` that hands out one ply's draws at a time
(at 65,536 games of 6x6 and 99 plies the whole tensor would take 234 GB,
one ply 2.4 GB).  JAX's ``jax.random.categorical`` over the uniform legal
logits is ``argmax(gumbel + logits)``, so the Gumbel draws of its keys
(``fold_in(k_steps, i)``) give the same plies here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tak.engine import TakEngine
from ..tak.state import where_state
from ..tak.symmetry import square_maps


def make_new_opening(eng: TakEngine, random_steps: int = 0):
    """Build ``new_opening(sym, pair, gumbel=None) -> TakState`` on the
    draws' device; ``gumbel`` (a tensor or a callable, see the module) is
    required when ``random_steps > 0``."""
    n = eng.n
    sqm = square_maps(n)  # [8, S]
    a1, an, xn = 0, (n - 1) * n, (n - 1) * n + (n - 1)
    pairs = np.array([[a1, an], [a1, xn]], np.int64)
    first = torch.from_numpy(sqm[:, pairs[:, 0]].T.astype(np.int64))  # [2, 8]
    second = torch.from_numpy(sqm[:, pairs[:, 1]].T.astype(np.int64))

    def new_opening(sym: torch.Tensor, pair: torch.Tensor, gumbel=None):
        dev = sym.device
        envs = eng.initial(sym.shape[0], dev)
        envs = eng.step(envs, first.to(dev)[pair, sym])  # channel 0: action == square
        envs = eng.step(envs, second.to(dev)[pair, sym])
        if random_steps and not (callable(gumbel) or (gumbel is not None and gumbel.shape[0] == random_steps)):
            raise ValueError(
                f"new_opening: {random_steps} random plies need gumbel [{random_steps}, B, A] or ply -> [B, A]"
            )
        for i in range(random_steps):
            draw = gumbel(i) if callable(gumbel) else gumbel[i]
            # argmax(gumbel + logits) over the uniform legal logits (0 or -inf).
            act = draw.masked_fill(~eng.legal_mask(envs), -torch.inf).argmax(-1)
            # A finished game keeps its position.
            envs = where_state(eng.terminal_kind(envs) != 0, envs, eng.step(envs, act))
        return envs

    return new_opening
