"""Network agents: weights + novelty state, and their evaluator.

Counterpart of ``takzero_tpu/models/agent.py``.  An agent *bundle* is a
dict:

* ``net``: the :class:`TakNet` module (eval mode; the learner trains it
  in place, see ``takzero_torch/train/learner.py``);
* ``folded``: its BN-folded inference weights (``fold_inference_params``),
  computed once and reused by every evaluation (the JAX program hoists the
  same fold out of its search loop).  Whoever changes ``net``'s weights
  drops ``folded``; :func:`folded_weights` refolds before the next
  evaluation;
* the novelty state of ``cfg.novelty``:

  - ``simhash``: ``hash_bits`` (the seen-set, int32 words holding the
    uint32 bit patterns) and ``hash_matrix`` f32[input_size, hash_bits];
  - ``lcghash``: ``hash_bits`` and ``hash_scale`` f32[C, N, N];
  - ``rnd``: ``rnd`` (an :class:`RndPair`; the learner trains its
    predictor in place) and the normalization bounds ``rnd_min`` and
    ``rnd_max`` (0-d float32);
  - ``ensemble``: ``ensemble`` (an :class:`EnsembleHeads`, never trained
    by the learner, as in the reference);
  - ``none``: nothing.

  The hash constants never train, so the hash indices of a position are
  the same from any bundle of one run: the hash-log protocol relies on it.

``net_evaluate(bundle, envs) -> (logits [B,A], value [B], variance [B])``
with ``variance = clip(max(exp(ube), novelty), 0, 4)``: a hash novelty is
4 for an unseen position and 0 for a seen one; RND's is the min/max
normalized predictor error scaled to [0, 4]; the ensemble's is the
variance across its heads.
"""

from __future__ import annotations

import functools

import numpy as np
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
    conv_precision,
    fold_inference_params,
    init_ensemble,
    init_network,
    init_rnd,
    simhash_matrix,
)

HASHED = ("simhash", "lcghash")

# 32-bit LCG fold constants (Numerical Recipes), as in the JAX package.
_LCG_A = 1664525
_LCG_C = 1013904223
_U32 = 0xFFFFFFFF


def new_agent(cfg: NetConfig, seed: int = 0, device=None) -> dict:
    """A fresh agent bundle with random weights drawn from ``seed``.

    Every random constant (the SimHash matrix, the LCG scale, the RND and
    ensemble weights) comes from a torch generator, so it differs from a
    JAX bundle of the same seed (bring a JAX bundle over with
    :func:`takzero_torch.bridge.from_jax_bundle` to share its hashes and
    weights).
    """
    dev = resolve_device(device)
    net = init_network(cfg, seed).to(dev)
    bundle = {"net": net, "folded": fold_inference_params(cfg, net)}
    if cfg.novelty in HASHED:
        bundle.update(new_hash_state(cfg, seed, dev))
    elif cfg.novelty == "rnd":
        bundle["rnd"] = init_rnd(cfg, seed + 1).to(dev)
        bundle["rnd_min"] = torch.zeros((), device=dev)
        bundle["rnd_max"] = torch.ones((), device=dev)
    elif cfg.novelty == "ensemble":
        bundle["ensemble"] = init_ensemble(cfg, seed + 2).to(dev)
    elif cfg.novelty != "none":
        raise ValueError(f"unknown novelty {cfg.novelty!r}")
    return bundle


def new_hash_state(cfg: NetConfig, seed: int = 0, device=None) -> dict:
    """The hash novelty state of :func:`new_agent` alone (an empty seen-set
    and the SimHash matrix or the LCG scale drawn from ``seed``), for users
    of the hash without a network (EEE's generalization experiment)."""
    dev = resolve_device(device)
    state = {"hash_bits": bitset_init(cfg.hash_bits, dev)}
    if cfg.novelty == "simhash":
        state["hash_matrix"] = simhash_matrix(cfg, seed).to(dev)
    elif cfg.novelty == "lcghash":
        gen = torch.Generator().manual_seed(seed ^ 0x1C6)
        state["hash_scale"] = torch.randn((input_channels(cfg.n), cfg.n, cfg.n), generator=gen).to(dev)
    else:
        raise ValueError(f"new_hash_state: {cfg.novelty!r} is not a hash novelty")
    return state


# ---------------------------------------------------------------------------
# Novelty estimators
# ---------------------------------------------------------------------------


def _without_side_to_move(cfg: NetConfig, planes: torch.Tensor) -> torch.Tensor:
    """A copy of ``planes`` with the side-to-move channel (C-2) set to +0.0,
    as in the reference ("too much of an impact")."""
    x = planes.clone()
    x[:, input_channels(cfg.n) - 2] = 0.0
    return x


def simhash_indices(cfg: NetConfig, matrix: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """int64[B] hash bucket per position (values of the uint32 word).

    Projection, sign and bit-pack run as one kernel (kernel B).
    """
    b = planes.shape[0]
    return simhash_pack(_without_side_to_move(cfg, planes).reshape(b, -1), matrix)


@functools.lru_cache(maxsize=None)
def _lcg_closed_form(k: int):
    """(weights int64[k], const): A^(k-1-i) and C * sum_j A^j, mod 2^32."""
    pows = [1] * k
    for i in range(1, k):
        pows[i] = (pows[i - 1] * _LCG_A) & _U32
    weights = np.asarray([pows[k - 1 - i] for i in range(k)], np.int64)
    return weights, (_LCG_C * sum(pows)) & _U32


def lcg_fold(words: torch.Tensor) -> torch.Tensor:
    """int64[B]: the 32-bit LCG fold ``acc = A*acc + C + x_i`` (from acc = 0)
    over each row of ``words`` (int64[B, K], values of uint32 words).

    Taken in closed form, ``sum_i A^(K-1-i) * x_i + C * sum_j A^j (mod
    2^32)``, in int64 without overflow: each weight is split into 16-bit
    halves, ``x*w = x*w_lo + ((x*w_hi mod 2^16) << 16) (mod 2^32)``, so a
    term is below 2^49 and a sum of K <= 4,096 terms fits.
    """
    weights, const = _lcg_closed_form(words.shape[1])
    w = torch.from_numpy(weights).to(words.device)
    terms = words * (w & 0xFFFF) + (((words * (w >> 16)) & 0xFFFF) << 16)
    return (terms.sum(-1) + const) & _U32


def lcghash_indices(cfg: NetConfig, scale: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """int64[B]: :func:`lcg_fold` of the bit patterns of the scaled planes
    (net4_lcghash.rs), shifted to ``hash_bits``; equal to JAX's bit for bit.

    The side-to-move channel is zeroed before the multiplication, as JAX
    does: +0.0 times a negative scale is -0.0, whose bits are 0x80000000.
    """
    b = planes.shape[0]
    x = (_without_side_to_move(cfg, planes) * scale[None]).reshape(b, -1)
    acc = lcg_fold(x.contiguous().view(torch.int32).to(torch.int64) & _U32)
    if cfg.hash_bits < 32:
        acc = acc >> (32 - cfg.hash_bits)
    return acc


def hash_indices(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    """int64[B] bitset indices of a plane batch (SimHash: kernel B on the card)."""
    if cfg.novelty == "simhash":
        return simhash_indices(cfg, bundle["hash_matrix"], planes)
    return lcghash_indices(cfg, bundle["hash_scale"], planes)


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
def rnd_raw(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    """f32[B] predictor-target squared error, the predictor in eval mode."""
    with conv_precision(cfg.compute_dtype):
        return bundle["rnd"](planes)


def rnd_novelty(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    """min/max-normalized RND error scaled to [0, 4] (net4_rnd.rs:225-230)."""
    err = rnd_raw(cfg, bundle, planes)
    lo, hi = bundle["rnd_min"], bundle["rnd_max"]
    norm = (err - lo) / torch.clamp(hi - lo, min=1e-8)
    return torch.clamp(norm, 0.0, 1.0) * MAXIMUM_VARIANCE


@torch.no_grad()
def rnd_update_normalization(cfg: NetConfig, bundle: dict, early_planes, late_planes) -> dict:
    """Refresh the bounds in place from reference batches: ``rnd_min`` is the
    least predictor error on early-game positions, ``rnd_max`` the largest
    on late-game ones, at least ``rnd_min + 1e-6``
    (learn/src/rnd_normalization.rs:75-77).  Returns ``bundle``."""
    lo = torch.min(rnd_raw(cfg, bundle, early_planes))
    hi = torch.maximum(torch.max(rnd_raw(cfg, bundle, late_planes)), lo + 1e-6)
    bundle["rnd_min"].copy_(lo)
    bundle["rnd_max"].copy_(hi)
    return bundle


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
    BN-folded weights in ``bundle["folded"]``.  The ensemble heads read the
    folded tower's core, so no second tower runs.
    """
    if cfg.novelty not in (*HASHED, "rnd", "ensemble", "none"):
        raise ValueError(f"unknown novelty {cfg.novelty!r}")
    dev = resolve_device(device)
    ensemble = cfg.novelty == "ensemble"

    @torch.no_grad()
    def net_evaluate(bundle: dict, envs):
        if envs.ply.device.type != dev.type:
            raise ValueError(f"net_evaluate: envs on {envs.ply.device}, evaluator on {dev}")
        planes = state_to_planes(eng, envs)
        policy, value, ube, *core = apply_folded(cfg, folded_weights(cfg, bundle), planes, with_core=ensemble)
        if cfg.novelty in HASHED:
            local = hash_novelty(cfg, bundle, planes)
        elif cfg.novelty == "rnd":
            local = rnd_novelty(cfg, bundle, planes)
        elif ensemble:
            with conv_precision(cfg.compute_dtype):
                local = torch.var(bundle["ensemble"](core[0]), dim=-1, correction=0)
        else:
            local = torch.zeros_like(value)
        variance = torch.maximum(torch.exp(ube), local).clamp(0.0, MAXIMUM_VARIANCE)
        return policy, value, variance

    return net_evaluate


@torch.no_grad()
def core_only(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    """The residual tower's output in eval mode (running statistics), in
    ``compute_dtype`` [B, F, N, N]: JAX's ``_core_only``, the unfolded
    module's numerics (EEE's ensemble reads its heads on it)."""
    core = bundle["net"].core
    mode = core.training
    core.eval()
    try:
        with conv_precision(cfg.compute_dtype):
            return core(planes)
    finally:
        core.train(mode)
