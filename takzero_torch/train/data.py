"""Target batches from ``Target`` objects, and pre-training targets from
uniformly random games.

Counterpart of ``make_batch`` (learn/src/main.rs:330-373: symmetry
augmentation and the input, mask and policy tensors; EEE's ensemble
experiment builds its batches with it), ``random_pretraining_targets`` and
``_host_opening`` in ``takzero_tpu/train/data.py`` (learn/src/main.rs:425-483: random games,
uniform policy over the legal moves, discounted terminal value, maximum
variance UBE).  The JAX package plays its games on its C++ oracle; the
port plays them on its own engine, a batch of games at a time on the
given device.  The games differ draw for draw from the oracle's, so the
two are held to the same rules, not to equal targets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.native_loader import augment_states
from ..data.target import Target
from ..device import resolve_device
from ..ops.repr import scatter_policy, state_to_planes
from ..search import eval as ev
from ..search.openings import make_new_opening
from ..tak.engine import TakEngine
from ..tak.state import TakState, where_state
from ..tak.symmetry import action_maps
from ..tak.tps import state_to_tps, tps_fields
from .learner import Batch

MAX_PLIES = 400
GAMES = 64  # games played at a time


def _ev_negate(flag: int, ply: int):
    if flag == ev.WIN:
        return ev.LOSS, ply + 1
    if flag == ev.LOSS:
        return ev.WIN, ply + 1
    return flag, ply + 1


def _ev_float(flag: int, ply: int, discount: float) -> float:
    sign = {ev.WIN: 1.0, ev.LOSS: -1.0, ev.DRAW: 0.0}[flag]
    return sign * discount**ply


def _host_opening(eng: TakEngine, rng: np.random.Generator, games: int, device) -> TakState:
    """The reference opening (two corner flats under a symmetry) for
    ``games`` games, the symmetry and the corner pair drawn from ``rng``."""
    sym = torch.from_numpy(rng.integers(0, 8, size=games)).to(device)
    pair = torch.from_numpy(rng.integers(0, 2, size=games)).to(device)
    return make_new_opening(eng)(sym, pair)


def stack_states(states) -> TakState:
    """Stack single positions (e.g. from ``tps_to_state``) into a batch."""
    return TakState(*(torch.stack(xs) for xs in zip(*states)))


def make_batch(eng: TakEngine, targets: list[Target], rng: np.random.Generator, augment: bool = True,
               return_states: bool = False, device=None):
    """A training :class:`Batch` of ``targets`` on ``device`` (default
    ``cuda``; raises without CUDA), each under a symmetry drawn by one
    ``rng.integers(0, 8)`` per target in target order, as JAX's
    ``make_batch`` draws them (``augment=False``: the identity, no draw).
    ``return_states`` also returns the augmented batched states on
    ``device``."""
    dev = resolve_device(device)
    n = eng.n
    syms = np.array([int(rng.integers(0, 8)) if augment else 0 for _ in targets], np.int64)
    fields = [tps_fields(n, t.tps) for t in targets]
    states = TakState(**{k: torch.from_numpy(np.stack([f[k] for f in fields])) for k in TakState._fields})
    states = augment_states(n, states, syms).map(lambda x: x.to(dev))
    rows = np.repeat(np.arange(len(targets)), [len(t.policy) for t in targets])
    acts = np.array([a for t in targets for a, _ in t.policy], np.int64)
    probs = np.array([p for t in targets for _, p in t.policy], np.float32)
    policy, mask = scatter_policy(len(targets), eng.num_actions, rows, action_maps(n)[syms[rows], acts], probs, dev)
    batch = Batch(
        planes=state_to_planes(eng, states),
        policy=policy,
        mask=mask,
        value=torch.tensor([t.value for t in targets], dtype=torch.float32, device=dev),
        ube=torch.tensor([t.ube for t in targets], dtype=torch.float32, device=dev),
    )
    return (batch, states) if return_states else batch


def _random_actions(legal: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The ``floor(u * count)``-th legal action of each row, u in [0, 1)."""
    count = legal.sum(-1)
    k = torch.minimum((u * count).long(), (count - 1).clamp(min=0))
    return (legal.cumsum(-1) > k[:, None]).int().argmax(-1)


def random_pretraining_targets(
    eng: TakEngine,
    count: int,
    rng: np.random.Generator,
    max_variance: float = 4.0,
    device=None,
) -> list[Target]:
    """``count`` targets from uniformly random games, played ``GAMES`` at a
    time on ``device`` (default ``cuda``; raises without CUDA).

    Each game starts from the reference opening and plays uniformly random
    legal moves; a game that reaches ``MAX_PLIES`` is discarded.  Every
    position before a move becomes a target: the uniform policy over its
    legal moves, the terminal result negated and discounted back to it,
    and UBE just under ``max_variance``.
    """
    dev = resolve_device(device)
    n = eng.n
    ube = float(max_variance - np.finfo(np.float32).eps)
    out: list[Target] = []
    while len(out) < count:
        state = _host_opening(eng, rng, GAMES, dev)
        done = eng.terminal_kind(state) != 0
        history = []  # per ply: (host state, legal rows, active lanes)
        for _ in range(MAX_PLIES):
            if not bool((~done).any()):
                break
            legal = eng.legal_mask(state)
            action = _random_actions(legal, torch.from_numpy(rng.random(GAMES)).to(dev))
            history.append((state.map(lambda x: x.cpu()), legal.cpu().numpy(), (~done).cpu().numpy()))
            state = where_state(~done, eng.step(state, action), state)
            done = done | (eng.terminal_kind(state) != 0)
        kind = eng.terminal_kind(state).cpu().numpy()
        for g in np.flatnonzero(done.cpu().numpy()):
            flag, ply = int(kind[g]), 0  # terminal kind for the final side to move
            for st, legal, active in reversed(history):
                if not active[g]:
                    continue
                flag, ply = _ev_negate(flag, ply)
                moves = np.flatnonzero(legal[g])
                p = 1.0 / len(moves)
                out.append(Target(
                    tps=state_to_tps(n, st.map(lambda x, g=g: x[g])),
                    value=_ev_float(flag, ply, ev.DISCOUNT),
                    ube=ube,
                    policy=[(int(a), p) for a in moves],
                    n=n,
                ))
    return out[:count]
