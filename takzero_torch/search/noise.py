"""Dirichlet exploration noise on the root policy.

Counterpart of ``takzero_tpu/search/noise.py`` (reference
takzero/src/search/node/noise.rs:10-26): mix each root child's
probability with a Dirichlet(alpha) sample at ``ratio``
(p' = (1-ratio)*p + ratio*d) and store ln(p') as its logit, so the
PUCT and improved-policy formulas see one policy.  Neither package's
selfplay calls it (the reference samples its roots with Gumbel noise).

Randomness comes in as a tensor, as everywhere in the port: ``gamma`` is
the Gamma(alpha) draw per root slot that JAX's ``jax.random.gamma`` makes
from its key; :func:`gamma_draws` makes one from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from .tree import Tree


def gamma_draws(generator: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """f32 Gamma(alpha, 1) samples of ``shape`` on the generator's device."""
    conc = torch.full(shape, float(alpha), dtype=torch.float32, device=generator.device)
    return torch._standard_gamma(conc, generator=generator)


def apply_dirichlet(tree: Tree, gamma: torch.Tensor, ratio: float) -> Tree:
    """Mix Dirichlet noise into every root child slot's probability: the
    tree with new root probabilities and logits (the pool is not changed).

    ``gamma`` f32[B, C] holds Gamma(alpha) draws; zeroed on invalid slots
    (action < 0) and normalised per row they are the Dirichlet sample over
    the valid slots, so the mixed distribution still sums to 1.  Invalid
    slots keep probability 0 and logit 0.
    """
    prob = tree.child_prob[:, 0, :]
    valid = tree.child_action[:, 0, :] >= 0
    g = torch.where(valid, gamma.to(prob.dtype), 0.0)
    d = g / g.sum(-1, keepdim=True).clamp(min=1e-30)
    mixed = torch.where(valid, (1.0 - ratio) * prob + ratio * d, 0.0)
    logit = torch.where(valid, torch.log(mixed.clamp(min=1e-30)), 0.0)
    child_prob, child_logit = tree.child_prob.clone(), tree.child_logit.clone()
    child_prob[:, 0, :] = mixed
    child_logit[:, 0, :] = logit
    return tree._replace(child_prob=child_prob, child_logit=child_logit)
