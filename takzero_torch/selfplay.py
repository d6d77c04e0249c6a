"""Selfplay move program: one Gumbel search move over the whole game batch.

Counterpart of the device half of ``takzero_tpu/selfplay.py``
(``SelfplayConfig`` and ``SelfplayEngine._move``, :121-217): Gumbel
sequential halving, weighted-random selection for the first plies, the
improved policy and UBE target, stepping with terminal detection, fresh
openings for finished games, tree reuse through ``descend_batch`` and one
packed int32 buffer with the same column layout as the JAX program's.

Randomness is drawn apart from computing: :meth:`SelfplayEngine.move`
takes a ``draws`` dict (see :func:`make_draws`), so tests can feed the
JAX program's own draws.  The host target assembly of ``play_move`` is not
part of this module yet.

Trees are updated in place: the search writes into the tree it is given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device
from .search import eval as ev
from .search.gumbel import make_gumbel_search, sh_schedule
from .search.openings import make_new_opening
from .search.policy import improved_policy, select_selfplay_slot, slot_action, ube_target
from .search.tree import Tree, descend_batch, init_tree, reset_lanes, truncation_stats
from .tak.engine import TakEngine
from .tak.state import where_state


@dataclass(frozen=True)
class SelfplayConfig:
    batch: int = 128
    beta: float = 0.25
    exploration: bool = False  # beta on the first half of the batch
    weighted_random_plies: int = 10
    sampled_actions: int = 64
    search_budget: int = 768
    max_children: int = 128
    max_depth: int = 48
    discount: float = ev.DISCOUNT
    tree_reuse: bool = True
    reuse_carry_cap: int = 384

    @property
    def max_nodes(self) -> int:
        cap = min(self.reuse_carry_cap, self.search_budget)
        return self.search_budget + 8 + (cap if self.tree_reuse else 0)

    @property
    def improved_policy_visitations(self) -> float:
        _, _, _, cums = sh_schedule(self.sampled_actions, self.search_budget)
        return float(cums[-1])

    def betas(self) -> np.ndarray:
        out = np.zeros(self.batch, np.float32)
        if self.exploration:
            out[: self.batch // 2] = self.beta
        return out


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def make_draws(generator: torch.Generator, batch: int, children: int) -> dict:
    """The random draws of one move, on the generator's device.

    ``gumbel_root`` f32[B, C] samples the root actions; ``gumbel_sample``
    f32[B, C] is the noise of the weighted-random selection (a categorical
    draw is ``argmax(log_weights + gumbel)``); ``open_sym`` i64[B] in [0, 8)
    and ``open_pair`` i64[B] in [0, 2) pick the fresh openings.
    """
    dev = generator.device
    return dict(
        gumbel_root=_gumbel(generator, (batch, children)),
        gumbel_sample=_gumbel(generator, (batch, children)),
        open_sym=torch.randint(0, 8, (batch,), generator=generator, device=dev),
        open_pair=torch.randint(0, 2, (batch,), generator=generator, device=dev),
    )


def _as_i32(x: torch.Tensor, b: int) -> torch.Tensor:
    """Column block of the packed buffer: floats bitcast, ints narrowed."""
    x = x.reshape(b, -1)
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    return x.to(torch.int32)


class SelfplayEngine:
    """Drives ``cfg.batch`` concurrent games on ``device`` (default ``cuda``).

    ``evaluator_factory(agent, envs) -> (logits, value, variance)`` is the
    network evaluator (:func:`takzero_torch.models.agent.make_net_evaluate`).
    """

    def __init__(self, eng: TakEngine, cfg: SelfplayConfig, evaluator_factory, device=None):
        self.eng = eng
        self.cfg = cfg
        self.device = resolve_device(device)
        self.evaluator_factory = evaluator_factory
        self._opening = make_new_opening(eng)
        self._betas = torch.from_numpy(cfg.betas()).to(self.device)
        self.envs = None
        self.tree: Tree | None = None

    def reset(self, draws: dict) -> None:
        """Fresh openings (from ``draws["open_sym"]``/``["open_pair"]``)
        and fresh trees."""
        self.envs = self._opening(draws["open_sym"].to(self.device), draws["open_pair"].to(self.device))
        self.tree = init_tree(self.eng, self.envs, self.cfg.max_nodes, self.cfg.max_children)

    def move(self, envs, tree: Tree, agent, draws: dict):
        """One move in every game: ``(nxt, tree_out, packed, root)``.

        ``tree`` is searched in place.  ``packed`` is int32[B, ...] in the
        JAX program's column layout: action, terminal kind, result, winner
        road, UBE (f32 bits), improved policy [C] (f32 bits), root child
        actions [C], the next state's height, owner_lo, owner_hi, tops [S]
        each, reserves [4], to_move, ply, reversible, truncation stats [2]
        and the root's incomplete bit.
        """
        cfg, eng = self.cfg, self.eng
        evaluator = lambda e: self.evaluator_factory(agent, e)  # noqa: E731
        search = make_gumbel_search(
            eng, evaluator, cfg.sampled_actions, cfg.search_budget, cfg.max_depth
        )
        if not cfg.tree_reuse:
            tree = init_tree(eng, envs, cfg.max_nodes, cfg.max_children)
        tree, slot = search(tree, draws["gumbel_root"], self._betas)
        weighted = envs.ply < cfg.weighted_random_plies
        sp_slot = select_selfplay_slot(tree, draws["gumbel_sample"])
        slot = torch.where(weighted, sp_slot, slot)
        action = slot_action(tree, slot)

        pol = improved_policy(tree, cfg.improved_policy_visitations)
        child_actions = tree.child_action[:, 0, :]
        ube = ube_target(tree, cfg.beta)

        stepped = eng.step(envs, action.clamp(min=0))
        tk = eng.terminal_kind(stepped)  # from the stepped side's view
        res = eng.game_result(stepped)  # winner colour / draw
        roads = eng._roads(stepped)  # [B, 2]
        winner_road = roads.gather(1, res.clamp(0, 1).to(torch.int64)[:, None])[:, 0]
        fresh = self._opening(draws["open_sym"], draws["open_pair"])
        done = tk != 0
        nxt = where_state(done, fresh, stepped)
        root = dict(
            action=child_actions,
            visit=tree.child_visit[:, 0, :],
            flag=tree.child_flag[:, 0, :],
            ply=tree.child_ply[:, 0, :],
            value=tree.child_value[:, 0, :],
            std=tree.child_std[:, 0, :],
            logit=tree.child_logit[:, 0, :],
        )
        b = action.shape[0]
        # The int64 colour field viewed as int32 pairs is (lo, hi) bits.
        owner = nxt.owner.contiguous().view(torch.int32).reshape(b, -1, 2)
        packed = torch.cat(
            [
                _as_i32(x, b)
                for x in (
                    action, tk, res, winner_road, ube, pol, child_actions,
                    nxt.height, owner[..., 0], owner[..., 1], nxt.tops,
                    nxt.reserves, nxt.to_move, nxt.ply, nxt.reversible,
                    truncation_stats(tree), tree.node_incomplete[:, 0],
                )
            ],
            dim=1,
        )
        if cfg.tree_reuse:
            # Carry the chosen subtree; finished games, unexpanded choices
            # and subtrees too large for a full budget of headroom restart.
            tree2, ok = descend_batch(
                tree, slot, min_headroom=cfg.search_budget + 1, max_chain=cfg.max_depth
            )
            tree_out = reset_lanes(tree2, done | ~ok, nxt)
        else:
            tree_out = tree
        return nxt, tree_out, packed, root
