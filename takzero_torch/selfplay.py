"""Selfplay engine: the move program on the device, target assembly on the host.

Counterpart of ``takzero_tpu/selfplay.py``.  The device half
(:meth:`SelfplayEngine.move`): Gumbel sequential halving, weighted-random
selection for the first plies, the improved policy and UBE target,
stepping with terminal detection, fresh openings for finished games, tree
reuse through ``descend_batch`` and one packed int32 buffer with the same
column layout as the JAX program's.  The host half
(:meth:`SelfplayEngine.play_move`): one blocking copy of that buffer per
move, per-game pending targets and replays, and the discounted values
back-filled when a game ends (selfplay/src/main.rs:263-329).

Randomness is drawn apart from computing: ``reset``, ``move`` and
``play_move`` take a ``draws`` dict (see :func:`make_draws`), so tests can
feed the JAX program's own draws.

Trees are updated in place: the search writes into the tree it is given.

Over the ranks of a data-parallel job (``world``) each rank plays its rows
of the game batch: it takes its rows of every draw (the draws are made at
the global shape on every rank, so world N plays world 1's games), and the
packed buffer is gathered, one collective a move, so every rank keeps the
whole batch's host state and game logs (JAX's ``replicate_fetch``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .data.target import Replay, Target, pad_policy_with_legal, result_str_from
from .device import resolve_device
from .search import eval as ev
from .search.core import with_agent
from .search.gumbel import make_gumbel_search, sh_schedule
from .search.openings import make_new_opening
from .search.policy import improved_policy, select_selfplay_slot, slot_action, ube_target
from .search.tree import Tree, descend_batch, init_tree, reset_lanes, truncation_stats
from .tak.engine import TakEngine
from .tak.moves import action_to_ptn
from .tak.state import TakState, where_state
from .tak.tps import state_to_tps
from .utils.profile import span


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


@dataclass
class PendingTarget:
    tps: str
    policy: list  # [(action, prob)]
    ube: float
    ply: int


@dataclass
class GameLog:
    start_tps: str
    actions: list = field(default_factory=list)
    pending: list = field(default_factory=list)


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
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
        gumbel_root=gumbel_noise(generator, (batch, children)),
        gumbel_sample=gumbel_noise(generator, (batch, children)),
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
    With ``world`` (a ``parallel.mesh.World``) the device holds this rank's
    rows of the games; ``envs`` and ``tree`` are the rank's.  ``topk`` is
    the search's expansion top-k (``search.core.make_topk``).
    """

    def __init__(self, eng: TakEngine, cfg: SelfplayConfig, evaluator_factory, device=None, world=None,
                 topk: str = "auto"):
        self.eng = eng
        self.topk = topk
        self.cfg = cfg
        self.device = resolve_device(device)
        self.evaluator_factory = evaluator_factory
        self.world = world
        self._opening = make_new_opening(eng)
        self._betas = self._rows(torch.from_numpy(cfg.betas()).to(self.device))
        self.envs = None
        self.tree: Tree | None = None
        self.logs: list[GameLog] = []
        self.last_root = None
        self._envs_host = None
        # [expanded nodes, incomplete (child-truncated) nodes] summed over
        # every post-search tree this engine has produced.
        self.truncation_totals = [0, 0]
        # Host time of play_move after the readback: unpacking, TPS
        # strings, policy lists, back-filled values.
        self.host_seconds = 0.0

    def _rows(self, x):
        return x if self.world is None else self.world.rows(x)

    def reset(self, draws: dict) -> None:
        """Fresh openings (from ``draws["open_sym"]``/``["open_pair"]``),
        fresh trees and fresh game logs."""
        envs = self._opening(draws["open_sym"].to(self.device), draws["open_pair"].to(self.device))
        self._envs_host = _host_state(envs)
        self.envs = envs.map(lambda x: self._rows(x).clone())
        self.tree = init_tree(self.eng, self.envs, self.cfg.max_nodes, self.cfg.max_children)
        self.logs = [GameLog(start_tps=self._tps(self._envs_host, i)) for i in range(self.cfg.batch)]

    def _tps(self, host: TakState, i: int) -> str:
        return state_to_tps(self.eng.n, host.map(lambda x: x[i]))

    def play_move(self, agent, draws: dict):
        """One move in every game.

        Returns ``(targets, replays, exploration_replays)`` completed by
        this move (exploration replays only where the lane's beta > 0).
        The packed buffer is the one blocking device-to-host copy; the
        pre-move host state is the previous move's copy.  The device half,
        the copy and the host half are the spans ``selfplay.move``,
        ``sync`` and ``selfplay.host_half``.
        """
        envs_before = self._envs_host
        draws = {k: self._rows(v.to(self.device)) for k, v in draws.items()}
        with span("selfplay.move"):
            nxt, tree_out, packed, root = self.move(self.envs, self.tree, agent, draws)
        self.envs, self.tree = nxt, tree_out
        self.last_root = root  # on the device; read by --dump-search only
        if self.world is not None:
            packed = self.world.gather(packed)
        with span("sync"):
            pk = packed.cpu().numpy()
        t0 = time.perf_counter()
        with span("selfplay.host_half"):
            out = self._host_half(pk, envs_before)
        self.host_seconds += time.perf_counter() - t0
        return out

    def _host_half(self, pk: np.ndarray, envs_before: TakState):
        """Unpack the move's buffer ``pk``, queue each game's pending
        target and complete the games that ended: ``play_move``'s return."""
        cfg, eng = self.cfg, self.eng
        s, c = eng.n * eng.n, cfg.max_children
        cuts = np.cumsum([1, 1, 1, 1, 1, c, c, s, s, s, s, 4, 1, 1, 1, 2])
        if pk.shape[1] != cuts[-1] + 1:
            raise ValueError(f"packed move buffer has {pk.shape[1]} columns, expected {cuts[-1] + 1}")
        (
            action, tk, res, road, ube_b, pol_b, child_actions,
            height, owner_lo, owner_hi, tops, reserves, to_move, ply,
            reversible, trunc, root_inc,
        ) = np.split(pk, cuts, axis=1)
        self.truncation_totals[0] += int(trunc[:, 0].sum())
        self.truncation_totals[1] += int(trunc[:, 1].sum())
        lo = owner_lo.astype(np.int64) & 0xFFFFFFFF
        nxt_host = TakState(
            height=np.ascontiguousarray(height),
            owner=lo | (owner_hi.astype(np.int64) << 32),
            tops=np.ascontiguousarray(tops),
            reserves=np.ascontiguousarray(reserves).reshape(-1, 2, 2),
            to_move=to_move[:, 0],
            ply=ply[:, 0],
            reversible=reversible[:, 0],
        )
        self._envs_host = nxt_host
        ube = np.ascontiguousarray(ube_b).view(np.float32)[:, 0]
        pol = np.ascontiguousarray(pol_b).view(np.float32)
        betas = cfg.betas()

        targets: list[Target] = []
        replays: list[Replay] = []
        exploration_replays: list[Replay] = []
        for i in range(cfg.batch):
            log = self.logs[i]
            valid = child_actions[i] >= 0
            policy_i = list(zip(child_actions[i][valid].tolist(), pol[i][valid].tolist()))
            if root_inc[i, 0]:
                # Truncated root: pad the missing legal actions at p=0 so
                # the line lists exactly every legal action.
                lane = envs_before.map(lambda x: torch.from_numpy(np.ascontiguousarray(x[i : i + 1])))
                policy_i = pad_policy_with_legal(policy_i, eng.legal_mask(lane)[0].numpy())
            log.pending.append(PendingTarget(
                tps=self._tps(envs_before, i), policy=policy_i, ube=float(ube[i]),
                ply=int(envs_before.ply[i]),
            ))
            log.actions.append(int(action[i, 0]))
            if tk[i, 0] != 0:
                t, r, er = self._complete_game(log, int(tk[i, 0]), float(betas[i]), int(res[i, 0]),
                                               bool(road[i, 0]))
                targets.extend(t)
                replays.append(r)
                if er is not None:
                    exploration_replays.append(er)
                self.logs[i] = GameLog(start_tps=self._tps(nxt_host, i))
        return targets, replays, exploration_replays

    def _complete_game(self, log: GameLog, terminal_kind: int, beta: float, res: int, road: bool):
        """Back-fill discounted values (selfplay/src/main.rs:263-329)."""
        cfg, n = self.cfg, self.eng.n
        # Eval::from(terminal) at the final position, negated per ply back.
        flag, ply = terminal_kind, 0
        targets = []
        for pend in reversed(log.pending):
            flag, ply = ev_negate_host(flag, ply)
            value = ev_float_host(flag, ply, cfg.discount)
            if beta == 0.0 or pend.ply > cfg.weighted_random_plies:
                targets.append(Target(tps=pend.tps, value=value, ube=pend.ube, policy=pend.policy, n=n))
        replay = Replay(tps=log.start_tps, actions=list(log.actions), result=result_str_from(res, road), n=n)
        exploration = None
        if beta > 0.0:
            exploration = Replay(tps=log.start_tps, actions=log.actions[: cfg.weighted_random_plies],
                                 result="", n=n)
        return targets, replay, exploration

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
        search = make_gumbel_search(
            eng, with_agent(self.evaluator_factory, agent), cfg.sampled_actions, cfg.search_budget,
            cfg.max_depth, self.topk,
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


def _host_state(envs: TakState) -> TakState:
    """A device state as numpy arrays on the host."""
    return envs.map(lambda x: x.cpu().numpy())


def ev_negate_host(flag: int, ply: int):
    if flag == ev.WIN:
        return ev.LOSS, ply + 1
    if flag == ev.LOSS:
        return ev.WIN, ply + 1
    return flag, ply + 1


def ev_float_host(flag: int, ply: int, discount: float) -> float:
    sign = {ev.WIN: 1.0, ev.LOSS: -1.0, ev.DRAW: 0.0}[flag]
    return sign * discount**ply


def dump_root_line(n: int, root: dict, lane: int = 0) -> str:
    """One search-dump line, ``move:visits:eval:std:logit,...`` over the
    valid root children: the format ``takzero_tpu/tools/analyze_search.py``
    reads.  ``root`` holds numpy arrays (``SelfplayEngine.last_root`` moved
    to the host)."""

    def eval_str(flag, ply, value):
        if flag == ev.WIN:
            return f"Win({ply})"
        if flag == ev.LOSS:
            return f"Loss({ply})"
        if flag == ev.DRAW:
            return f"Draw({ply})"
        return f"{value:.6f}"

    items = []
    for j in range(root["action"].shape[1]):
        a = int(root["action"][lane, j])
        if a < 0:
            continue
        items.append(
            f"{action_to_ptn(n, a)}:{int(root['visit'][lane, j])}:"
            f"{eval_str(int(root['flag'][lane, j]), int(root['ply'][lane, j]), float(root['value'][lane, j]))}:"
            f"{float(root['std'][lane, j]):.6f}:{float(root['logit'][lane, j]):.6f}"
        )
    return ",".join(items) + ","
