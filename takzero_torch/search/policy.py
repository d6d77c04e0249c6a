"""Root-level policy utilities for the batched trees.

Counterpart of ``takzero_tpu/search/policy.py``: improved policy, UBE
target, UCT scores, best / selfplay slot selection over the ``[B, C]``
root slots.
Randomness comes in as tensors: ``select_selfplay_slot`` takes the Gumbel
draw that JAX's ``jax.random.categorical`` adds to the log-weights.
"""

from __future__ import annotations

import torch

from . import eval as ev
from .tree import Tree


def root_children(tree: Tree) -> dict:
    return dict(
        action=tree.child_action[:, 0, :],
        logit=tree.child_logit[:, 0, :],
        prob=tree.child_prob[:, 0, :],
        visit=tree.child_visit[:, 0, :],
        flag=tree.child_flag[:, 0, :],
        ply=tree.child_ply[:, 0, :],
        value=tree.child_value[:, 0, :],
        std=tree.child_std[:, 0, :],
        node=tree.child_node[:, 0, :],
    )


def improved_policy(tree: Tree, visitations) -> torch.Tensor:
    """[B, C] improved policy over root slots (softmax over valid slots).

    ``visitations`` is one count for every root (a float) or one per root
    (a [B] tensor, as reanalyze passes the most visited child's count).
    """
    ch = root_children(tree)
    valid = ch["action"] >= 0
    needs_init = (ch["node"] < 0) & (ch["flag"] == ev.VALUE) & (ch["visit"] == 0)
    root_f = ev.eval_to_float(tree.root_flag, tree.root_ply, tree.root_value)
    completed = torch.where(
        needs_init, root_f[:, None], ev.negated_float(ch["flag"], ch["ply"], ch["value"])
    )
    if isinstance(visitations, torch.Tensor):
        sqrt_v = torch.sqrt(visitations.to(torch.float32))[:, None]
    else:
        sqrt_v = torch.sqrt(torch.tensor(visitations, dtype=torch.float32)).item()
    score = torch.where(valid, ch["logit"] + completed * sqrt_v, -torch.inf)
    score = score - score.max(-1, keepdim=True).values
    e = torch.where(valid, torch.exp(score), 0.0)
    return e / e.sum(-1, keepdim=True).clamp(min=1e-30)


def most_visited_count(tree: Tree) -> torch.Tensor:
    """[B] visits of the most visited root child."""
    return tree.child_visit[:, 0, :].max(-1).values


def ube_target(tree: Tree, beta: float) -> torch.Tensor:
    """[B] sigma^2 of argmax_child(q + beta*sigma); 0 if the root is solved."""
    ch = root_children(tree)
    valid = ch["action"] >= 0
    q = ev.negated_float(ch["flag"], ch["ply"], ch["value"])
    score = torch.where(valid, q + beta * ch["std"], -torch.inf)
    std = _take(ch["std"], score.argmax(-1))
    solved = (tree.root_flag != ev.VALUE) | ~tree.root_expanded()
    return torch.where(solved, 0.0, std * std)


def uct_scores(tree: Tree, node_visit, beta) -> torch.Tensor:
    """[B, C] classic UCT scores over the root slots, the reference's
    declared-but-unused ``select_with_uct`` (policy.rs:104-117):
    ``q + C*sqrt(ln(N)/n) + beta*std`` with ``EXPLORATION_COEFFICIENT=1``
    (policy.rs:158-164); -inf on invalid slots and on winning children
    unless the node is a proven loss (policy.rs:109).  ``node_visit`` and
    ``beta`` are one number or one per root."""
    ch = root_children(tree)
    valid = ch["action"] >= 0
    q = ev.negated_float(ch["flag"], ch["ply"], ch["value"])
    dev = q.device
    nv = torch.as_tensor(node_visit, dtype=torch.float32, device=dev).clamp(min=1.0)
    if nv.dim() == 1:
        nv = nv[:, None]
    u = torch.sqrt(torch.log(nv) / ch["visit"].to(torch.float32).clamp(min=1e-9))
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev).expand(q.shape[0])
    pruned = (ch["flag"] == ev.WIN) & (tree.root_flag != ev.LOSS)[:, None]
    return torch.where(valid & ~pruned, q + u + beta[:, None] * ch["std"], -torch.inf)


def select_best_slot(tree: Tree) -> torch.Tensor:
    """[B] child slot: the solved root's worst-for-opponent child, else the
    most visited child, else the highest prior."""
    ch = root_children(tree)
    valid = ch["action"] >= 0
    solved_slot = ev.argmin_eval(ch["flag"], ch["ply"], ch["value"], valid)
    visits = torch.where(valid, ch["visit"], -1)
    most_visited = visits.argmax(-1)
    no_visits = visits.max(-1).values <= 0
    by_prob = torch.where(valid, ch["prob"], -1.0).argmax(-1)
    unsolved_slot = torch.where(no_visits, by_prob, most_visited)
    return torch.where(tree.root_flag != ev.VALUE, solved_slot, unsolved_slot)


def select_selfplay_slot(
    tree: Tree,
    gumbel: torch.Tensor,
    threshold: int = 32,
    allowed_eval_drop: float = 0.5,
) -> torch.Tensor:
    """[B] proportional-to-visits sampling with filters.

    ``gumbel`` f32[B, C] is the noise of the categorical draw: the sample is
    ``argmax(log(weights) + gumbel)``, which is exactly what
    ``jax.random.categorical`` computes from its key.
    """
    ch = root_children(tree)
    valid = ch["action"] >= 0
    best = ev.argmin_eval(ch["flag"], ch["ply"], ch["value"], valid)
    bf, bp, bv = ev.take_eval(ch["flag"], ch["ply"], ch["value"], best)
    bv = bv + torch.where(bf == ev.VALUE, allowed_eval_drop, 0.0)
    bprim, bsec = ev.order_keys(bf, bp, bv)
    cprim, csec = ev.order_keys(ch["flag"], ch["ply"], ch["value"])
    exceeds = (cprim > bprim[:, None]) | ((cprim == bprim[:, None]) & (csec > bsec[:, None]))
    ok = valid & (ch["visit"] >= threshold) & (ch["flag"] != ev.WIN) & ~exceeds
    weights = torch.where(ok, ch["visit"].float(), 0.0)
    any_ok = weights.sum(-1) > 0
    sampled = (torch.log(weights.clamp(min=1e-30)) + gumbel).argmax(-1)
    solved = tree.root_flag != ev.VALUE
    return torch.where(solved | ~any_ok, select_best_slot(tree), sampled)


def slot_action(tree: Tree, slot: torch.Tensor) -> torch.Tensor:
    return _take(tree.child_action[:, 0, :], slot)


def _take(row: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return row.gather(1, slot.to(torch.int64)[:, None])[:, 0]
