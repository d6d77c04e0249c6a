"""Gumbel sequential halving at the root.

Counterpart of ``takzero_tpu/search/gumbel.py``: one plain simulation so
every root is initialised, a Gumbel top-k sample of ``sampled_actions``
root children, ``log2(k)`` phases of forced-root simulations, halving by
logit + Gumbel + sigma, and a final recomputation of the root statistics.

The schedule is static, so the ``budget`` simulations run as a plain
Python loop.  The root sample and the halving use a *sorted* top-k over
the C root slots; a stable descending sort stands for ``lax.top_k`` (ties,
which only -inf entries of invalid slots produce, go to the lower index).
The Gumbel noise comes in as a tensor (``gumbel`` f32[B, C]).
"""

from __future__ import annotations

import numpy as np
import torch

from ..tak.engine import TakEngine
from . import eval as ev
from .core import make_simulate, solve_children
from .tree import Tree


def sh_schedule(sampled_actions: int, budget: int):
    """Static per-simulation schedule: (rank, alive, halve, cum_visits)."""
    k = sampled_actions
    steps = k.bit_length() - 1
    assert k >= 2 and (k & (k - 1)) == 0, "sampled_actions must be a power of 2, at least 2"
    assert budget > 0, "budget must be positive"
    assert budget % (steps * k) == 0, "budget must divide k*log2(k) evenly"
    vps = budget // steps
    ranks, alive, halve, cums = [], [], [], []
    m, cum = k, 0
    for _ in range(steps):
        vpa = vps // m
        for i in range(m):
            for _ in range(vpa):
                ranks.append(i)
                alive.append(m)
                halve.append(False)
                cums.append(0)
        cum += vpa
        halve[-1] = True
        cums[-1] = cum
        m //= 2
    return (
        np.array(ranks, np.int32),
        np.array(alive, np.int32),
        np.array(halve),
        np.array(cums, np.int32),
    )


def _sorted_top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def make_gumbel_search(
    eng: TakEngine,
    evaluator,
    sampled_actions: int = 64,
    budget: int = 768,
    max_depth: int = 48,
    topk: str = "auto",
):
    simulate = make_simulate(eng, evaluator, max_depth=max_depth, topk=topk)
    ranks, alive, halve, cums = sh_schedule(sampled_actions, budget)
    k = sampled_actions

    def search(tree: Tree, gumbel: torch.Tensor, betas: torch.Tensor):
        """Returns ``(tree, chosen_slot [B])``; ``tree`` is updated in place.
        On a CUDA device the middles of its simulations replay from CUDA
        graphs captured in its second simulation (``search_scope``)."""
        with simulate.search_scope(tree) as sim:
            return _search(sim, tree, gumbel, betas)

    def _search(simulate, tree: Tree, gumbel: torch.Tensor, betas: torch.Tensor):
        b, _, c = tree.child_visit.shape
        dev = tree.child_visit.device
        betas = betas.to(device=dev, dtype=torch.float32).expand(b)

        tree = simulate(tree, betas)  # root initialisation

        valid = tree.child_action[:, 0, :] >= 0
        noisy = torch.where(valid, tree.child_logit[:, 0, :] + gumbel, -torch.inf)
        sel_score, sel_idx = _sorted_top_k(noisy, k)
        sel_valid = sel_score > -torch.inf
        sel_count = sel_valid.sum(-1)
        arange_k = torch.arange(k, device=dev)

        for t in range(len(ranks)):
            cnt = sel_count.clamp(max=int(alive[t])).clamp(min=1)
            ii = int(ranks[t]) % cnt
            slot = sel_idx.gather(1, ii[:, None])[:, 0].clamp(min=0)
            tree = simulate(tree, 0.0, forced_slot=slot, skip_root=True)
            if halve[t]:
                # Re-rank the alive entries by logit + gumbel + sigma.
                root = (tree.child_flag, tree.child_ply, tree.child_value, tree.child_std)
                flag, ply, val, std = (a[:, 0, :].gather(1, sel_idx) for a in root)
                q = ev.negated_float(flag, ply, val)
                sigma = (q + betas[:, None] * std) * (50.0 + float(cums[t]))
                total = torch.where(sel_valid, sel_score + sigma, -torch.inf)
                _, order = _sorted_top_k(total, k)
                sel_idx = sel_idx.gather(1, order)
                sel_score = sel_score.gather(1, order)
                sel_valid = sel_valid.gather(1, order) & (arange_k < int(alive[t]) // 2)
        chosen_slot = sel_idx[:, 0]

        # Recompute root statistics.
        ch_visit = tree.child_visit[:, 0, :]
        ch_flag = tree.child_flag[:, 0, :]
        ch_ply = tree.child_ply[:, 0, :]
        ch_val = tree.child_value[:, 0, :]
        ch_prob = tree.child_prob[:, 0, :]
        root_visit = torch.where(valid, ch_visit, 0).sum(-1, dtype=torch.int32) + 1

        any_loss = (valid & (ch_flag == ev.LOSS)).any(-1)
        closed, (sf, sp, sv) = solve_children(ch_flag, ch_ply, ch_val, valid, tree.node_incomplete[:, 0])
        solved = any_loss | closed

        visited = valid & (ch_visit > 0)
        q = ev.negated_float(ch_flag, ch_ply, ch_val)
        sum_p = torch.where(visited, ch_prob, 0.0).sum(-1)
        wq = torch.where(visited, ch_prob * q, 0.0).sum(-1)
        weighted = wq / sum_p.clamp(min=1e-30)

        was_known = tree.root_flag != ev.VALUE
        tree.root_visit.copy_(root_visit)
        tree.root_flag.copy_(torch.where(solved, sf, torch.where(was_known, tree.root_flag, 0)))
        tree.root_ply.copy_(torch.where(solved, sp, torch.where(was_known, tree.root_ply, 0)))
        tree.root_value.copy_(
            torch.where(solved, sv, torch.where(was_known, tree.root_value, weighted))
        )
        tree.root_std.copy_(torch.where(solved, 0.0, tree.root_std))
        return tree, chosen_slot

    return search
