"""Training step and losses.

Counterpart of ``takzero_tpu/train/learner.py``.  The loss is the
reference learner's (learn/src/main.rs:375-423):

* policy: cross entropy between the improved-policy target and the
  move-masked log-softmax of the policy head, summed then divided by the
  batch size;
* value: MSE against the discounted n-step return;
* UBE: MSE in log-variance space, the target clamped to [-10, ln 4]
  (off during pre-training);
* RND nets add ``loss_rnd``, the mean predictor-target squared error on
  the batch inputs (learn/src/main.rs:404), and train the predictor with
  the net;
* after each step the hash seen-set (SimHash, LCG hash) is updated with
  the batch inputs.

The port trains in place: a step updates the bundle's ``net`` (weights and
BatchNorm running statistics), the RND predictor and ``hash_bits``, and
the optimizer's state, and drops the bundle's ``folded`` weights (see
``models/agent.py:folded_weights``).  The optimizer is optax's ``adam``
as ``torch.optim.Adam`` over :func:`trainable_of`.  Parameters that get no
gradient (the UBE head while ``train_ube`` is False) get zero gradients,
not ``None``: torch's Adam skips a parameter without a gradient and does
not advance its step count, while optax gives it a zero update and
advances its one global count; the first UBE step would otherwise use
another bias correction.  The RND target is not in the optimizer: optax
holds it, but its gradient is zero (stop_gradient), so Adam's update of it
is exactly zero.

With ``world`` (a :class:`~takzero_torch.parallel.mesh.World` whose group
is active) the batch is this rank's rows of the global batch, as under
JAX's data-parallel step (``axis_name`` there): BatchNorm takes global
statistics (``network.global_batch_stats``), each rank back-propagates
its share of the global mean loss (its local mean over the world size, so
the gradients summed over the ranks are the gradient of the global mean),
the gradients are summed as one flat buffer, the metrics are averaged
(JAX's ``pmean``) and the seen-set takes every rank's indices.  Adam then
applies the same gradients on every rank, so the parameters stay
bit-identical.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.agent import HASHED, hash_update
from ..models.network import MAXIMUM_VARIANCE, NetConfig, TakNet, conv_precision, global_batch_stats
from ..parallel import multihost

MINIMUM_UBE_TARGET = -10.0
F32_MIN = torch.finfo(torch.float32).min


class Batch(NamedTuple):
    planes: torch.Tensor  # [B, C, N, N]
    policy: torch.Tensor  # [B, A] target probabilities (zeros on illegal)
    mask: torch.Tensor  # [B, A] bool, True = legal
    value: torch.Tensor  # [B]
    ube: torch.Tensor  # [B] raw variance target (log+clamp applied here)


def loss_fn(cfg: NetConfig, net: TakNet, batch: Batch, train_ube: bool):
    """(loss, metrics) of ``net`` on ``batch``.

    Call it with ``net`` in train mode: the forward then normalises with
    batch statistics and updates the running ones in place.
    """
    return losses_of(batch, *net(batch.planes), train_ube)


def losses_of(batch: Batch, policy, value, ube, train_ube: bool):
    """(loss, metrics) of the heads' outputs on ``batch`` (see :func:`loss_fn`)."""
    b = policy.shape[0]
    masked = torch.where(batch.mask, policy, F32_MIN)
    logp = torch.log_softmax(masked, dim=-1)
    loss_policy = -torch.sum(logp * batch.policy) / b
    loss_value = torch.mean((batch.value - value) ** 2)
    target_ube = torch.clamp(
        torch.log(torch.clamp(batch.ube, min=1e-12)), MINIMUM_UBE_TARGET, math.log(MAXIMUM_VARIANCE)
    )
    loss_ube = torch.mean((target_ube - ube) ** 2) if train_ube else torch.zeros_like(loss_value)
    loss = loss_policy + loss_value + loss_ube
    metrics = {
        "loss": loss.detach(),
        "loss_policy": loss_policy.detach(),
        "loss_value": loss_value.detach(),
        "loss_ube": loss_ube.detach(),
    }
    return loss, metrics


def trainable_of(bundle: dict) -> list:
    """The parameters the optimizer tracks: the net's, and the RND
    predictor's.  The ensemble heads are not here: the reference's learn
    binary never trains them (eee/src/ensemble.rs:320-339), and
    ``drivers/learn.py`` warns that they stay at their initialisation."""
    params = list(bundle["net"].parameters())
    if "rnd" in bundle:
        params += list(bundle["rnd"].predictor.parameters())
    return params


def make_optimizer(bundle: dict, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """optax's ``adam(learning_rate)``: betas (0.9, 0.999), eps 1e-8
    (reference: Adam lr=1e-4, learn:122)."""
    return torch.optim.Adam(trainable_of(bundle), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(cfg: NetConfig, world=None):
    """Build ``train_step(bundle, opt, batch, train_ube) -> metrics``.

    ``metrics`` maps names to 0-d float32 tensors on the batch's device;
    nothing waits for the device.  With an active ``world`` the batch is
    this rank's rows (see the module's docstring).
    """
    sharded = world is not None and world.active

    def train_step(bundle: dict, opt: torch.optim.Optimizer, batch: Batch, train_ube: bool) -> dict:
        net, rnd = bundle["net"], bundle.get("rnd")
        modules = (net,) if rnd is None else (net, rnd)
        for mod in modules:
            mod.train()
        opt.zero_grad(set_to_none=False)
        with conv_precision(cfg.compute_dtype), global_batch_stats(sharded):
            loss, metrics = loss_fn(cfg, net, batch, train_ube)
            if rnd is not None:
                # The predictor in train mode (batch statistics, running
                # statistics updated); the target stays in eval mode.
                loss_rnd = torch.mean(rnd(batch.planes))
                loss = loss + loss_rnd
                metrics = {**metrics, "loss": loss.detach(), "loss_rnd": loss_rnd.detach()}
            (loss / world.size if sharded else loss).backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if sharded:
            multihost.all_reduce_flat([p.grad for p in params])
            keys = sorted(metrics)
            mean = multihost.all_reduce_mean(torch.stack([metrics[k] for k in keys]))
            metrics = dict(zip(keys, mean.unbind()))
        opt.step()
        for mod in modules:
            mod.eval()
        bundle.pop("folded", None)
        if cfg.novelty in HASHED:
            hash_update(cfg, bundle, batch.planes, world)
        return metrics

    return train_step


def make_train_step_chunk(cfg: NetConfig, world=None):
    """Build ``chunk_step(bundle, opt, batches, train_ube) -> metrics``.

    ``batches`` is a :class:`Batch` of [K, B, ...] tensors; the chunk is K
    calls of ``train_step`` in order (JAX's ``lax.scan``), and each metric
    comes back stacked to [K].
    """
    step = make_train_step(cfg, world)

    def chunk_step(bundle: dict, opt: torch.optim.Optimizer, batches: Batch, train_ube: bool) -> dict:
        per_step = [
            step(bundle, opt, Batch(*(x[k] for x in batches)), train_ube)
            for k in range(batches.planes.shape[0])
        ]
        return {name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}

    return chunk_step
