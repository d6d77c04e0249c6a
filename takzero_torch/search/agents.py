"""Batched test evaluators: ``envs -> (policy_logits [B,A], value [B], var [B])``.

Counterpart of ``takzero_tpu/search/agents.py``: ``dummy_evaluator``
(uniform logits, zero value and uncertainty) and ``simple_evaluator``
(piece-type logits, flat-difference value).
"""

from __future__ import annotations

import numpy as np
import torch

from ..tak.engine import TakEngine


def dummy_evaluator(eng: TakEngine):
    """Uniform policy, zero value/uncertainty."""
    a = eng.num_actions

    def evaluate(envs):
        b, dev = envs.ply.shape[0], envs.ply.device
        zeros = torch.zeros((b,), dtype=torch.float32, device=dev)
        return torch.ones((b, a), dtype=torch.float32, device=dev), zeros, zeros

    return evaluate


def simple_evaluator(eng: TakEngine):
    """Logits: flat placement 4, cap 3, wall 2, spreads 1.  Value:
    (flat_diff - half_komi/2) / N^2 from the mover's perspective (integer
    half of the komi, as in the reference)."""
    sp = eng.space
    s = sp.num_squares
    per_channel = np.ones(sp.num_channels, np.float32)
    per_channel[0], per_channel[1], per_channel[2] = 4.0, 2.0, 3.0
    logits = torch.from_numpy(np.repeat(per_channel, s))
    komi_half = int(np.trunc(eng.half_komi / 2))

    def evaluate(envs):
        b, dev = envs.ply.shape[0], envs.ply.device
        fcd = (eng.flat_diff(envs).float() - komi_half) / s
        value = torch.where(envs.to_move == 1, -fcd, fcd)
        return (
            logits.to(dev).expand(b, -1),
            value,
            torch.zeros((b,), dtype=torch.float32, device=dev),
        )

    return evaluate
