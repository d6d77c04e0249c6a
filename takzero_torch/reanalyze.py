"""Reanalyze core: fresh targets from old replay positions.

Counterpart of ``takzero_tpu/reanalyze.py`` (reference
reanalyze/src/main.rs:146-228): fresh trees over sampled stored positions,
Gumbel sequential halving with beta 0, then targets with

* value = the chosen child's negated Q (or the solved root's eval),
* policy = the improved policy at the most visited child's visit count,
* ube = ``ube_target`` at beta 0.25.

The search's Gumbel draws come in as a tensor, as in ``selfplay.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.target import Target, pad_policy_with_legal
from .search import eval as ev
from .search.core import with_agent
from .search.gumbel import make_gumbel_search
from .search.policy import improved_policy, most_visited_count, slot_action, ube_target
from .search.tree import init_tree
from .tak.engine import TakEngine
from .tak.tps import tps_to_state


def make_reanalyze_step(
    eng: TakEngine,
    evaluator_factory,
    sampled_actions: int = 64,
    search_budget: int = 768,
    max_children: int = 128,
    max_depth: int = 48,
    ube_target_beta: float = 0.25,
):
    """``step(envs, agent, gumbel f32[B, C]) -> (action, policy [B, C],
    child actions [B, C], ube, value, root incomplete)`` on the envs' device."""
    max_nodes = search_budget + 8

    def step(envs, agent, gumbel: torch.Tensor):
        search = make_gumbel_search(eng, with_agent(evaluator_factory, agent), sampled_actions, search_budget,
                                    max_depth)
        b, dev = envs.ply.shape[0], envs.ply.device
        tree = init_tree(eng, envs, max_nodes, max_children)
        tree, slot = search(tree, gumbel.to(dev), torch.zeros(b, device=dev))

        pick = lambda a: a[:, 0, :].gather(1, slot.to(torch.int64)[:, None])[:, 0]  # noqa: E731
        child_q = ev.negated_float(pick(tree.child_flag), pick(tree.child_ply), pick(tree.child_value))
        root_f = ev.eval_to_float(tree.root_flag, tree.root_ply, tree.root_value)
        value = torch.where(tree.root_flag != ev.VALUE, root_f, child_q)

        pol = improved_policy(tree, most_visited_count(tree).to(torch.float32))
        ube = ube_target(tree, ube_target_beta)
        return (
            slot_action(tree, slot),
            pol,
            tree.child_action[:, 0, :],
            ube,
            value,
            tree.node_incomplete[:, 0],
        )

    return step


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_targets(n, tps_batch, pol, child_actions, ube, value, incomplete=None, eng=None) -> list[Target]:
    """Target rows from one reanalyze step.  With ``incomplete`` and the
    port's engine ``eng``, child-truncated roots pad the missing legal
    actions at p=0, so each line lists exactly every legal action
    (reference wire contract, target.rs:123-134)."""
    pol, child_actions, ube, value = (_host(x) for x in (pol, child_actions, ube, value))
    incomplete = np.zeros(len(tps_batch), bool) if incomplete is None else _host(incomplete).astype(bool)
    out = []
    for i, tps in enumerate(tps_batch):
        valid = child_actions[i] >= 0
        policy = list(zip(child_actions[i][valid].tolist(), pol[i][valid].tolist()))
        if incomplete[i] and eng is not None:
            state = tps_to_state(n, tps).map(lambda x: x[None])
            policy = pad_policy_with_legal(policy, eng.legal_mask(state)[0].numpy())
        out.append(Target(tps=tps, value=float(value[i]), ube=float(ube[i]), policy=policy, n=n))
    return out
