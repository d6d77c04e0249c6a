"""Network agents: weights + novelty state, and their evaluator.

Counterpart of ``takzero_tpu/models/agent.py`` for the ``simhash`` and
``none`` novelty variants.  An agent *bundle* is a dict:

* ``net``: the :class:`TakNet` module (eval mode; the learner trains it
  in place, see ``takzero_torch/train/learner.py``);
* ``folded``: its BN-folded inference weights (``fold_inference_params``),
  computed once and reused by every evaluation (the JAX program hoists the
  same fold out of its search loop).  Whoever changes ``net``'s weights
  drops ``folded``; :func:`folded_weights` refolds before the next
  evaluation;
* for ``simhash``: ``hash_bits`` (the seen-set, int32 words holding the
  uint32 bit patterns) and ``hash_matrix`` f32[input_size, hash_bits].
  The matrix never trains, so the hash indices of a position are the same
  from any bundle of one run: the hash-log protocol relies on it.

``net_evaluate(bundle, envs) -> (logits [B,A], value [B], variance [B])``
with ``variance = clip(max(exp(ube), novelty), 0, 4)``; SimHash novelty is
4 for an unseen position and 0 for a seen one.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.bitset import bitset_init, bitset_query, bitset_set
from ..ops.repr import input_channels, state_to_planes
from ..ops.simhash import simhash_pack
from ..tak.engine import TakEngine
from .network import (
    MAXIMUM_VARIANCE,
    NetConfig,
    apply_folded,
    fold_inference_params,
    init_network,
    simhash_matrix,
)

NOVELTY = ("simhash", "none")


def _check_novelty(cfg: NetConfig) -> None:
    if cfg.novelty not in NOVELTY:
        raise NotImplementedError(
            f"takzero_torch ports the {NOVELTY} novelty variants; got {cfg.novelty!r}"
        )


def new_agent(cfg: NetConfig, seed: int = 0, device=None) -> dict:
    """A fresh agent bundle with random weights drawn from ``seed``.

    The SimHash matrix comes from a torch generator, so it hashes
    differently from a JAX bundle of the same seed (bring a JAX bundle over
    with :func:`takzero_torch.bridge.from_jax_bundle` to share its hashes).
    """
    _check_novelty(cfg)
    dev = resolve_device(device)
    net = init_network(cfg, seed).to(dev)
    bundle = {"net": net, "folded": fold_inference_params(cfg, net)}
    if cfg.novelty == "simhash":
        bundle["hash_bits"] = bitset_init(cfg.hash_bits, dev)
        bundle["hash_matrix"] = simhash_matrix(cfg, seed).to(dev)
    return bundle


def simhash_indices(cfg: NetConfig, matrix: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """int64[B] hash bucket per position (values of the uint32 word).

    The side-to-move channel (C-2) is zeroed first, as in the reference.
    Projection, sign and bit-pack run as one kernel (kernel B).
    """
    b = planes.shape[0]
    x = planes.clone()
    x[:, input_channels(cfg.n) - 2] = 0.0
    return simhash_pack(x.reshape(b, -1), matrix)


def hash_indices(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    """int64[B] bitset indices of a plane batch (kernel B on the card)."""
    return simhash_indices(cfg, bundle["hash_matrix"], planes)


def hash_novelty(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    seen = bitset_query(bundle["hash_bits"], hash_indices(cfg, bundle, planes))
    return torch.where(seen, 0.0, MAXIMUM_VARIANCE)


def hash_update(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> dict:
    """Mark the positions of ``planes`` as seen, in place; returns ``bundle``."""
    bitset_set(bundle["hash_bits"], hash_indices(cfg, bundle, planes))
    return bundle


def hash_indices_fresh(cfg: NetConfig, bundle: dict, planes: torch.Tensor):
    """(int64[B] indices, bool[B] fresh): the fresh bits are not yet set in
    ``bundle["hash_bits"]``.  The learner calls this on the bundle before a
    train step (whose ``hash_update`` sets the same bits) and appends only
    the fresh indices to ``hash_log.bin``, which keeps the log bounded by
    the number of distinct bits ever set."""
    idx = hash_indices(cfg, bundle, planes)
    return idx, ~bitset_query(bundle["hash_bits"], idx)


@torch.no_grad()
def folded_weights(cfg: NetConfig, bundle: dict) -> dict:
    """``bundle["folded"]``, refolded from ``bundle["net"]`` if a train step
    dropped it."""
    if "folded" not in bundle:
        bundle["folded"] = fold_inference_params(cfg, bundle["net"])
    return bundle["folded"]


def make_net_evaluate(cfg: NetConfig, eng: TakEngine, device=None):
    """Build ``net_evaluate(bundle, envs) -> (logits, value, variance)``.

    Runs on ``device`` (default ``cuda``; raises without CUDA), on the
    BN-folded weights in ``bundle["folded"]``.
    """
    _check_novelty(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def net_evaluate(bundle: dict, envs):
        if envs.ply.device.type != dev.type:
            raise ValueError(f"net_evaluate: envs on {envs.ply.device}, evaluator on {dev}")
        planes = state_to_planes(eng, envs)
        policy, value, ube = apply_folded(cfg, folded_weights(cfg, bundle), planes)
        if cfg.novelty == "simhash":
            local = hash_novelty(cfg, bundle, planes)
        else:
            local = torch.zeros_like(value)
        variance = torch.maximum(torch.exp(ube), local).clamp(0.0, MAXIMUM_VARIANCE)
        return policy, value, variance

    return net_evaluate
