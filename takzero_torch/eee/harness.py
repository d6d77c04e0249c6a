"""Shared EEE batch builders (reference eee/src/utils.rs).

Counterpart of ``takzero_tpu/eee/harness.py``; so far only the random
reference batches that the RND normalization refresh reads
(``drivers/learn.py``, ``tiny_run.py``).
"""

from __future__ import annotations

import torch

from ..ops.repr import state_to_planes
from ..search.openings import make_new_opening
from ..selfplay import gumbel_noise
from ..tak.engine import TakEngine


def random_plane_batch(eng: TakEngine, gen: torch.Generator, ply: int, batch: int) -> torch.Tensor:
    """[B, C, N, N] planes of random games at the given ply, on ``gen``'s
    device.

    Matches eee/utils.rs ``reference_envs``: the standard two-corner-flats
    opening plus ``ply`` uniformly random steps (a finished game keeps its
    position).  The symmetry, the corner pair and one Gumbel draw per ply
    come from ``gen``, in that order.
    """
    dev = gen.device
    sym = torch.randint(0, 8, (batch,), generator=gen, device=dev)
    pair = torch.randint(0, 2, (batch,), generator=gen, device=dev)
    gumbel = gumbel_noise(gen, (ply, batch, eng.num_actions)) if ply else None
    return state_to_planes(eng, make_new_opening(eng, random_steps=ply)(sym, pair, gumbel))
