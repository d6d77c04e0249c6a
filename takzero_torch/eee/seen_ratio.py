"""EEE seen-ratio scan (reference eee/src/seen_ratio.rs).

Counterpart of ``takzero_tpu/eee/seen_ratio.py``: for a trained
hash-novelty agent, the fraction of random-game positions not yet in the
seen-set as a function of ply.  At each ply 0..max_ply-1 a fresh batch of
``batch`` random games is played to that ply (never one ply's games
carried on to the next: that would correlate the samples) and
mean(novelty) / MAXIMUM_VARIANCE is reported (1.0 = everything unseen).

Each ply's draws come from a generator seeded by (seed, ply), JAX's
``fold_in(seed, ply)``, and only one ply's Gumbel noise lives at a time
(65,536 games of 6x6 take 2.4 GB a ply).  Under SimHash kernel B runs
once per ply, on the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.agent import hash_novelty
from ..models.network import MAXIMUM_VARIANCE, NetConfig
from ..tak.engine import engine
from .harness import random_draws, random_planes


def ply_generator(seed: int, ply: int, device) -> torch.Generator:
    """The generator of one ply's games, seeded from (seed, ply)."""
    state = np.random.SeedSequence([seed, ply]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def run(
    bundle: dict,
    cfg: NetConfig,
    max_ply: int = 100,
    batch: int = 65_536,
    seed: int = 123,
    device=None,
    draws=None,
) -> list[tuple[int, float]]:
    """[(ply, unseen_ratio)] on ``device`` (default ``cuda``; raises without
    CUDA), printed as a Python-literal list like the reference
    (seen_ratio.rs:21-28).  ``draws(ply)``, if given, returns that ply's
    :func:`~takzero_torch.eee.harness.random_draws`-style dict (``sym``,
    ``pair``, ``gumbel``) in place of :func:`ply_generator`'s."""
    dev = resolve_device(device)
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    out = []
    print("random = [")
    for ply in range(max_ply):
        d = draws(ply) if draws is not None else random_draws(ply_generator(seed, ply, dev), batch, eng.num_actions)
        planes = random_planes(eng, ply, **d)
        ratio = float(torch.mean(hash_novelty(cfg, bundle, planes)) / MAXIMUM_VARIANCE)
        del planes
        out.append((ply, ratio))
        print(f"    ({ply}, {ratio}),")
    print("]")
    return out
