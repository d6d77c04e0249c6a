"""Batched Tak rules engine on torch tensors.

Counterpart of ``takzero_tpu/tak/engine.py``.  The JAX engine is written
for one state and ``vmap``-ed; here every function takes a batch-first
:class:`TakState` (``[B, ...]``) and works on the tensors' own device.
Rules, action layout and results are the JAX engine's exactly (held
against it on random playouts in ``tests/test_torch_tak.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .moves import DEFAULT_RESERVES, DIR_DELTAS, action_space
from .state import TakState, extract_bits, get_bit, initial_state_batch, low_mask


@functools.lru_cache(maxsize=None)
def _host_tables(n: int):
    """numpy tables for the legal mask and the spread step."""
    sp = action_space(n)
    s = n * n
    rows, cols = np.divmod(np.arange(s), n)
    # Square at (sq + i*delta) for each direction and offset 1..n-1.
    shift_idx = np.zeros((4, n - 1, s), np.int64)
    shift_ok = np.zeros((4, n - 1, s), bool)
    for d in range(4):
        dr, dc = int(DIR_DELTAS[d, 0]), int(DIR_DELTAS[d, 1])
        for i in range(1, n):
            r, c = rows + i * dr, cols + i * dc
            ok = (0 <= r) & (r < n) & (0 <= c) & (c < n)
            shift_ok[d, i - 1] = ok
            shift_idx[d, i - 1] = np.clip(r, 0, n - 1) * n + np.clip(c, 0, n - 1)
    k = sp.spread_k.astype(np.int64)
    last = sp.spread_drops[np.arange(len(k)), k - 1].astype(np.int64)
    needed = np.arange(1, n)[None, :] < k[:, None]  # [4P, n-1]
    flat_delta = (DIR_DELTAS[:, 0] * n + DIR_DELTAS[:, 1]).astype(np.int64)
    return dict(
        shift_idx=shift_idx.reshape(-1),
        shift_ok=shift_ok,
        dir=sp.spread_dir.astype(np.int64),
        k=k,
        carry=sp.spread_carry.astype(np.int64),
        last=last,
        needed=needed,
        drops=sp.spread_drops.astype(np.int64),
        pre=sp.spread_pre.astype(np.int64),
        flat_delta=flat_delta[sp.spread_dir],
    )


@dataclass(frozen=True)
class TakEngine:
    n: int
    half_komi: int = 0
    reversible_limit: int = 50

    @property
    def space(self):
        return action_space(self.n)

    @property
    def num_actions(self) -> int:
        return self.space.num_actions

    def tables(self, device) -> dict:
        return _device_tables(self.n, str(device))

    def initial(self, batch: int, device="cpu") -> TakState:
        return initial_state_batch(self.n, batch, device)

    # ------------------------------------------------------------------
    # Derived boards
    # ------------------------------------------------------------------
    def top_color(self, state: TakState) -> torch.Tensor:
        """Colour of the top piece per square (int32; 0 where empty)."""
        h = (state.height - 1).clamp(min=0)
        return get_bit(state.owner, h).to(torch.int32)

    def _shifted_tops(self, state: TakState) -> torch.Tensor:
        """tops at (sq + i*delta): int32[B, 4, n-1, S]; -1 off the board."""
        t = self.tables(state.tops.device)
        b = state.tops.shape[0]
        g = state.tops[:, t["shift_idx"]].reshape(b, 4, self.n - 1, -1)
        return torch.where(t["shift_ok"], g, -1)

    # ------------------------------------------------------------------
    # Legal move mask
    # ------------------------------------------------------------------
    def legal_mask(self, state: TakState) -> torch.Tensor:
        """bool[B, num_actions] in the policy-tensor layout."""
        t = self.tables(state.tops.device)
        me = state.to_move.long()
        b = me.shape[0]
        swap = (state.ply < 2)[:, None]
        empty = state.tops == 0
        res_me = state.reserves[torch.arange(b, device=me.device), me]  # [B, 2]
        stones_me = (res_me[:, 0] > 0)[:, None]
        caps_me = (res_me[:, 1] > 0)[:, None]

        place_flat = empty & (swap | stones_me)
        place_wall = empty & ~swap & stones_me
        place_cap = empty & ~swap & caps_me

        tc = self.top_color(state)
        control = (state.tops > 0) & (tc == state.to_move[:, None]) & ~swap
        shifted = self._shifted_tops(state)  # [B, 4, n-1, S]
        passable = (shifted == 0) | (shifted == 1)
        by_si = passable[:, t["dir"]]  # [B, 4P, n-1, S]
        inter_ok = (by_si | ~t["needed"][None, :, :, None]).all(dim=2)
        final_tops = shifted[:, t["dir"], t["k"] - 1]  # [B, 4P, S]
        final_ok = (final_tops == 0) | (final_tops == 1)
        is_cap = (state.tops == 3)[:, None, :]
        crush_ok = (final_tops == 2) & (t["last"] == 1)[None, :, None] & is_cap
        carry_ok = t["carry"][None, :, None] <= state.height.clamp(max=self.n)[:, None, :]
        spread = control[:, None, :] & carry_ok & inter_ok & (final_ok | crush_ok)
        place = torch.stack([place_flat, place_wall, place_cap], dim=1)
        return torch.cat([place, spread], dim=1).reshape(b, -1)

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------
    def step(self, state: TakState, action: torch.Tensor) -> TakState:
        """Apply one (assumed legal) action per lane; returns a new state."""
        s = self.n * self.n
        action = action.to(torch.int64)
        ch, sq = action // s, action % s
        is_place = ch < 3
        placed = self._place(state, ch, sq)
        spread = self._spread(state, ch - 3, sq)
        m = is_place
        out = []
        for a, bb in zip(placed, spread):
            out.append(torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, bb))
        nxt = TakState(*out)
        return nxt._replace(to_move=1 - state.to_move, ply=state.ply + 1)

    def _place(self, state: TakState, ch, sq) -> TakState:
        b = ch.shape[0]
        bar = torch.arange(b, device=ch.device)
        swap = state.ply < 2
        color = torch.where(swap, 1 - state.to_move, state.to_move).long()
        piece = (ch + 1).clamp(max=3)
        kind = (piece == 3).long()
        sqc = sq[:, None]
        height = state.height.scatter(1, sqc, torch.ones_like(sqc, dtype=torch.int32))
        owner = state.owner.scatter(1, sqc, state.owner.gather(1, sqc) | color[:, None])
        tops = state.tops.scatter(1, sqc, piece[:, None].to(torch.int32))
        reserves = state.reserves.clone()
        reserves[bar, color, kind] -= 1
        return state._replace(
            height=height,
            owner=owner,
            tops=tops,
            reserves=reserves,
            reversible=torch.zeros_like(state.reversible),
        )

    def _spread(self, state: TakState, si, sq) -> TakState:
        n = self.n
        t = self.tables(sq.device)
        si = si.clamp(0, 4 * self.space.num_patterns - 1)
        k = t["k"][si]
        carry = t["carry"][si]
        flat_delta = t["flat_delta"][si]

        sqc = sq[:, None]
        h = state.height.gather(1, sqc)[:, 0].long()
        own = state.owner.gather(1, sqc)[:, 0]
        # Garbage lanes (placements) may compute a negative start; clamp so
        # shifts stay defined.  Their result is discarded by step().
        start = (h - carry).clamp(0, 63)
        carried = extract_bits(own, start, carry)
        moving_top = state.tops.gather(1, sqc)

        height = state.height.scatter(1, sqc, start[:, None].to(torch.int32))
        owner = state.owner.scatter(1, sqc, (own & low_mask(start))[:, None])
        tops = state.tops.scatter(1, sqc, (start > 0).to(torch.int32)[:, None])

        crushed = torch.zeros_like(k, dtype=torch.bool)
        for i in range(1, n):  # masked beyond k
            active = (i <= k)[:, None]
            tsq = (sq + i * flat_delta).clamp(0, n * n - 1)[:, None]
            di = t["drops"][si, i - 1]
            pre = t["pre"][si, i - 1]
            chunk = (carried >> pre) & ((torch.ones_like(di) << di) - 1)
            ht = height.gather(1, tsq)
            new_owner = owner.gather(1, tsq) | (chunk[:, None] << ht.long())
            is_final = (i == k)[:, None]
            old_top = tops.gather(1, tsq)
            crushed = crushed | (active & is_final & (old_top == 2))[:, 0]
            new_top = torch.where(is_final, moving_top, 1)
            height = height.scatter(1, tsq, torch.where(active, ht + di[:, None].to(torch.int32), ht))
            owner = owner.scatter(1, tsq, torch.where(active, new_owner, owner.gather(1, tsq)))
            tops = tops.scatter(1, tsq, torch.where(active, new_top, old_top))

        return state._replace(
            height=height,
            owner=owner,
            tops=tops,
            reversible=torch.where(crushed, 0, state.reversible + 1).to(torch.int32),
        )

    # ------------------------------------------------------------------
    # Terminal detection
    # ------------------------------------------------------------------
    def _roads(self, state: TakState) -> torch.Tensor:
        """bool[B, 2]: does (white, black) have a completed road.

        Floods for a fixed n*n rounds like the JAX engine (no host check);
        a dilation is two separable 3-wide max-pools.
        """
        n = self.n
        b = state.tops.shape[0]
        tc = self.top_color(state)
        road_piece = (state.tops == 1) | (state.tops == 3)
        cells = torch.stack([road_piece & (tc == 0), road_piece & (tc == 1)], dim=1)
        cells4 = cells[:, [0, 0, 1, 1]].reshape(b, 4, n, n).to(torch.float32)
        dev = cells4.device
        col = torch.arange(n, device=dev)
        seed_h = (col[None, :] == 0).expand(n, n)
        seed_v = (col[:, None] == 0).expand(n, n)
        seeds = torch.stack([seed_h, seed_v, seed_h, seed_v]).to(torch.float32)
        reach = seeds[None] * cells4
        for _ in range(n * n):
            hor = F.max_pool2d(reach, (1, 3), stride=1, padding=(0, 1))
            ver = F.max_pool2d(reach, (3, 1), stride=1, padding=(1, 0))
            reach = cells4 * torch.maximum(hor, ver)
        reach = reach > 0
        done_h = reach[:, :, :, n - 1].any(dim=2)  # reached east column
        done_v = reach[:, :, n - 1, :].any(dim=2)  # reached north row
        white = done_h[:, 0] | done_v[:, 1]
        black = done_h[:, 2] | done_v[:, 3]
        return torch.stack([white, black], dim=1)

    def _flat_counts(self, state: TakState):
        tc = self.top_color(state)
        flat = state.tops == 1
        wf = (flat & (tc == 0)).sum(dim=1)
        bf = (flat & (tc == 1)).sum(dim=1)
        return wf, bf

    def game_result(self, state: TakState) -> torch.Tensor:
        """int32[B]: -1 ongoing, 0 white wins, 1 black wins, 2 draw."""
        roads = self._roads(state)
        both = roads[:, 0] & roads[:, 1]
        last_mover = (1 - state.to_move).long()
        road_winner = torch.where(
            both, last_mover, torch.where(roads[:, 0], 0, 1)
        )
        any_road = roads[:, 0] | roads[:, 1]
        board_full = (state.tops != 0).all(dim=1)
        out_of_pieces = (state.reserves.sum(dim=2) == 0).any(dim=1)
        flats_end = board_full | out_of_pieces
        wf, bf = self._flat_counts(state)
        w2, b2 = 2 * wf, 2 * bf + self.half_komi
        flat_winner = torch.where(w2 > b2, 0, torch.where(b2 > w2, 1, 2))
        no_progress = state.reversible >= self.reversible_limit
        out = torch.where(
            any_road,
            road_winner,
            torch.where(flats_end, flat_winner, torch.where(no_progress, 2, -1)),
        )
        return out.to(torch.int32)

    def terminal_kind(self, state: TakState) -> torch.Tensor:
        """int32[B]: 0 ongoing, 1 win (for to_move), 2 loss, 3 draw."""
        r = self.game_result(state)
        out = torch.where(
            r == -1, 0, torch.where(r == 2, 3, torch.where(r == state.to_move, 1, 2))
        )
        return out.to(torch.int32)

    def flat_diff(self, state: TakState) -> torch.Tensor:
        """white_flats - black_flats (white perspective, komi excluded)."""
        wf, bf = self._flat_counts(state)
        return (wf - bf).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, device: str) -> dict:
    return {
        k: torch.as_tensor(v, device=device) for k, v in _host_tables(n).items()
    }


@functools.lru_cache(maxsize=None)
def engine(n: int, half_komi: int = 0, reversible_limit: int = 50) -> TakEngine:
    assert n in DEFAULT_RESERVES, f"unsupported board size {n}"
    return TakEngine(n=n, half_komi=half_komi, reversible_limit=reversible_limit)
