"""Model-vs-model pit fighting.

Counterpart of ``takzero_tpu/evaluation.py`` (evaluation/src/main.rs:221-319,
``compete``): two agents alternate half-moves over a batch of openings; the
agent given first is "white" and makes the first move of every game.  A
terminal position is scored for the player who just moved, and finished
games are frozen.  Results are W/L/D from white's side.

Both agents keep their own tree for the whole game and descend it by every
move played, the mover's and the opponent's alike, so prior visits and
solver proofs carry across moves.  The opponent's tree is keyed by its own
slot layout, so the played action is located there first.

The Gumbel draws come from a ``torch.Generator``, or, for a test that
replays JAX's keys, from a sequence of per-half-move draws f32[B, C].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .search.core import with_agent
from .search.gumbel import make_gumbel_search
from .search.policy import slot_action
from .search.tree import descend_batch, init_tree, reset_lanes
from .selfplay import gumbel_noise
from .tak.engine import TakEngine
from .tak.state import where_state


@dataclass
class Evaluation:
    wins: int = 0
    losses: int = 0
    draws: int = 0
    half_moves: int = 0  # half-moves searched (not printed)

    def win_rate(self) -> float:
        total = self.wins + self.losses + self.draws
        return self.wins / total if total else 0.0

    def __str__(self) -> str:
        return f"Evaluation {{ wins: {self.wins}, losses: {self.losses}, draws: {self.draws} }}"


def make_compete(
    eng: TakEngine,
    evaluator_factory,
    sampled_actions: int = 64,
    search_budget: int = 768,
    max_children: int = 128,
    max_depth: int = 48,
    tree_reuse: bool | tuple[bool, bool] = True,
    reuse_carry_cap: int = 384,
    world=None,
):
    """Build ``compete(bundle_white, bundle_black, envs, gen=None,
    max_moves=200, draws=None) -> Evaluation``.

    ``tree_reuse`` is one bool for both agents or a ``(white, black)``
    pair (carried-subtree search against fresh-tree search at equal
    budget).  ``reuse_carry_cap`` bounds the pool rows reserved for a
    carried subtree.  ``evaluator_factory(bundle, envs)`` evaluates with an
    agent's weights.  With ``world`` (a ``parallel.mesh.World``) each rank
    plays its rows of the games, both agents whole on every rank; the draws
    are made for every game and the terminal kinds gathered each half-move,
    so every rank scores every game.  ``compete.half_move`` is one
    half-move of every game (the tests hold it against JAX's).
    """
    reuse_w, reuse_b = tree_reuse if isinstance(tree_reuse, tuple) else (tree_reuse, tree_reuse)
    any_reuse = reuse_w or reuse_b
    cap = min(reuse_carry_cap, search_budget)
    max_nodes = search_budget + 8 + (cap if any_reuse else 0)

    def half_move(envs, bundle, gumbel, frozen, my_tree, opp_tree, my_reuse: bool, opp_reuse: bool):
        """One half-move of every game: ``(next envs, terminal kind, my
        tree, opponent's tree)``.  Trees are updated in place or replaced."""
        search = make_gumbel_search(
            eng, with_agent(evaluator_factory, bundle), sampled_actions, search_budget, max_depth
        )
        b = envs.ply.shape[0]
        if not my_reuse:
            my_tree = init_tree(eng, envs, max_nodes, max_children)
        tree, slot = search(my_tree, gumbel, torch.zeros((b,), device=envs.ply.device))
        action = slot_action(tree, slot).clamp(min=0)
        # Finished games keep their final positions.
        nxt = where_state(frozen, envs, eng.step(envs, action))
        tk = torch.where(frozen, 0, eng.terminal_kind(nxt))
        if my_reuse:
            my2, ok_m = descend_batch(tree, slot, min_headroom=search_budget + 1, max_chain=max_depth)
            my_out = reset_lanes(my2, frozen | ~ok_m, nxt)
        else:
            my_out = tree
        if opp_reuse:
            hit = opp_tree.child_action[:, 0, :] == action[:, None]
            opp_slot = hit.to(torch.uint8).argmax(1)
            opp2, ok_o = descend_batch(opp_tree, opp_slot, min_headroom=search_budget + 1, max_chain=max_depth)
            opp_out = reset_lanes(opp2, frozen | ~(ok_o & hit.any(1)), nxt)
        else:
            opp_out = opp_tree
        return nxt, tk, my_out, opp_out

    def compete(bundle_white, bundle_black, envs, gen: torch.Generator | None = None,
                max_moves: int = 200, draws=None) -> Evaluation:
        """Play every game of ``envs`` to its end or ``max_moves`` moves a
        side.  Gumbel draws come from ``draws[i]`` for half-move ``i`` when
        given, else from ``gen``."""
        b = int(envs.ply.shape[0])
        dev = envs.ply.device
        done = np.zeros(b, bool)
        ev = Evaluation()
        rows = (lambda x: x) if world is None else world.rows  # noqa: E731
        cur = envs.map(rows)
        tree_w = init_tree(eng, cur, max_nodes, max_children)
        tree_b = init_tree(eng, cur, max_nodes, max_children)
        for move in range(2 * max_moves):
            if done.all():
                break
            is_white = move % 2 == 0
            bundle = bundle_white if is_white else bundle_black
            my, opp = (tree_w, tree_b) if is_white else (tree_b, tree_w)
            my_reuse, opp_reuse = (reuse_w, reuse_b) if is_white else (reuse_b, reuse_w)
            gumbel = draws[move].to(dev) if draws is not None else gumbel_noise(gen, (b, max_children))
            frozen = torch.from_numpy(done).to(dev)
            cur, tk, my, opp = half_move(cur, bundle, rows(gumbel), rows(frozen), my, opp, my_reuse, opp_reuse)
            if world is not None:
                tk = world.gather(tk)
            tree_w, tree_b = (my, opp) if is_white else (opp, my)
            ev.half_moves += 1
            tk = tk.cpu().numpy()
            for g in range(b):
                if done[g] or tk[g] == 0:
                    continue
                done[g] = True
                # The terminal kind is seen by the side to move after the
                # move: its loss is a win for the agent that moved.
                mover_won, mover_lost = tk[g] == 2, tk[g] == 1
                if tk[g] == 3:
                    ev.draws += 1
                elif (mover_won and is_white) or (mover_lost and not is_white):
                    ev.wins += 1
                else:
                    ev.losses += 1
        return ev

    compete.half_move = half_move
    return compete
