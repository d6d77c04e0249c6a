"""Random opening generation.

Counterpart of ``takzero_tpu/search/openings.py`` with ``random_steps=0``:
two flats on adjacent corners (a1, aN) or opposite corners (a1, xN), under
one of the 8 board symmetries.  The draws come in as tensors: ``sym``
int64[B] in [0, 8) and ``pair`` int64[B] in [0, 2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..tak.engine import TakEngine
from ..tak.symmetry import square_maps


def make_new_opening(eng: TakEngine):
    """Build ``new_opening(sym, pair) -> TakState`` on the draws' device."""
    n = eng.n
    sqm = square_maps(n)  # [8, S]
    a1, an, xn = 0, (n - 1) * n, (n - 1) * n + (n - 1)
    pairs = np.array([[a1, an], [a1, xn]], np.int64)
    first = torch.from_numpy(sqm[:, pairs[:, 0]].T.astype(np.int64))  # [2, 8]
    second = torch.from_numpy(sqm[:, pairs[:, 1]].T.astype(np.int64))

    def new_opening(sym: torch.Tensor, pair: torch.Tensor):
        dev = sym.device
        envs = eng.initial(sym.shape[0], dev)
        envs = eng.step(envs, first.to(dev)[pair, sym])  # channel 0: action == square
        return eng.step(envs, second.to(dev)[pair, sym])

    return new_opening
