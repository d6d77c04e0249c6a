"""Array-encoded game-theoretic evaluations.

Counterpart of ``takzero_tpu/search/eval.py``: the reference's ``Eval``
enum as three parallel tensors (``flag`` 0 Value / 1 Win / 2 Loss / 3 Draw,
``ply``, ``value``), with the same negation, discounted float conversion
and lexicographic total order.  ``argmin``/``argmax`` take the first index
on ties, as in JAX.
"""

from __future__ import annotations

import torch

DISCOUNT = 0.997
# Geometric-series sum of squared discounts (reference search/mod.rs:8;
# declared for UBE-style horizon math, unused by the training loop).
SERIES_DISCOUNT = 1.0 / (1.0 - DISCOUNT * DISCOUNT)
CONTEMPT = -0.05

VALUE, WIN, LOSS, DRAW = 0, 1, 2, 3

_BIG = 3.4e38


def eval_to_float(flag, ply, value):
    """f32(eval), gamma^ply discounted."""
    sign = torch.where(flag == WIN, 1.0, torch.where(flag == LOSS, -1.0, 0.0))
    base = torch.where(flag == VALUE, value, sign)
    disc = torch.where(flag == VALUE, 1.0, torch.pow(DISCOUNT, ply.float()))
    return base * disc


def negate(flag, ply, value):
    nf = torch.where(flag == WIN, LOSS, torch.where(flag == LOSS, WIN, flag))
    np_ = torch.where(flag == VALUE, ply, ply + 1)
    return nf.to(flag.dtype), np_, -value


def negated_float(flag, ply, value):
    """f32(eval.negate()): the q-value of a child."""
    return eval_to_float(*negate(flag, ply, value))


def order_keys(flag, ply, value):
    """Lexicographic (primary, secondary) sort keys; smaller = worse."""
    plyf = ply.float()
    primary = torch.where(
        flag == LOSS,
        -2.0,
        torch.where(flag == WIN, 2.0, torch.where(flag == DRAW, CONTEMPT, value)),
    )
    secondary = torch.where(
        flag == LOSS, plyf, torch.where((flag == WIN) | (flag == DRAW), -plyf, 0.0)
    )
    return primary, secondary


def argmin_eval(flag, ply, value, valid, dim=-1):
    """Index of the minimum (worst) eval along ``dim`` among ``valid`` entries."""
    primary, secondary = order_keys(flag, ply, value)
    primary = torch.where(valid, primary, _BIG)
    tie = primary == primary.min(dim=dim, keepdim=True).values
    secondary = torch.where(tie & valid, secondary, _BIG)
    return secondary.argmin(dim=dim)


def argmax_eval(flag, ply, value, valid, dim=-1):
    """Index of the maximum (best) eval along ``dim`` among ``valid`` entries."""
    primary, secondary = order_keys(flag, ply, value)
    primary = torch.where(valid, primary, -_BIG)
    tie = primary == primary.max(dim=dim, keepdim=True).values
    secondary = torch.where(tie & valid, secondary, -_BIG)
    return secondary.argmax(dim=dim)


def take_eval(flag, ply, value, idx, dim=-1):
    """Gather one eval triple at ``idx`` along ``dim``."""
    i = idx.unsqueeze(dim)
    return tuple(t.gather(dim, i).squeeze(dim) for t in (flag, ply, value))
