"""Shared EEE batch builders (reference eee/src/utils.rs).

Counterpart of ``takzero_tpu/eee/harness.py``.  Reference-batch semantics
(eee/utils.rs:34-96, eee/rnd.rs:136-179):

* early  -- unique replay positions at ply 8;
* late   -- unique replay positions at ply 60;
* random_early / random_late -- fresh random games to the same plies
  (standard openings + uniformly random legal steps);
* impossible_early -- a THIRD independent random-early batch with its
  first 8 input channels permuted ([6,7,4,5,2,3,0,1]: the side-to-move
  top one-hots swap into the stack-carry planes, eee/utils.rs:78-89).

A replay ply with fewer unique positions than the batch falls back to
random games at the same ply.  The draws come in explicitly, so a test can
feed JAX's: each random batch takes ``sym`` int64[B], ``pair`` int64[B] and
``gumbel`` (f32[ply, B, A], or a callable ``ply -> f32[B, A]`` that draws
one ply at a time, see ``search/openings.py``), and the replay pools are
picked by a numpy ``default_rng(seed)``.  :func:`reference_draws` makes
them from a torch generator.

Besides JAX's functions, the pieces the experiments share:
:func:`load_replay_positions` (the replay stream and its unique positions
per ply), :func:`unique_positions` (that grouping, also over the ensemble's
targets) and :class:`ForcedUsesBuffer` (the forced-uses training buffer of
``eee/rnd.py`` and ``eee/generalization.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.native_loader import read_replay_blocks
from ..ops.repr import input_channels, state_to_planes
from ..search.openings import make_new_opening
from ..selfplay import gumbel_noise
from ..tak.engine import TakEngine
from ..tak.state import TakState
from ..tak.tps import states_to_tps

REF_NAMES = ("early", "late", "random_early", "random_late", "impossible_early")


def impossible_permutation(n: int) -> np.ndarray:
    """Channel permutation producing impossible inputs (eee/utils.rs:79-89)."""
    head = [6, 7, 4, 5, 2, 3, 0, 1]
    return np.array(head + list(range(8, input_channels(n))), np.int32)


def planes_of(eng: TakEngine, envs: TakState) -> torch.Tensor:
    return state_to_planes(eng, envs)


def random_draws(gen: torch.Generator, batch: int, num_actions: int) -> dict:
    """The draws of one batch of random games on ``gen``'s device: the
    symmetry and the corner pair now, and a callable that draws one ply's
    Gumbel noise f32[B, A] from ``gen`` when that ply is played."""
    dev = gen.device
    return dict(
        sym=torch.randint(0, 8, (batch,), generator=gen, device=dev),
        pair=torch.randint(0, 2, (batch,), generator=gen, device=dev),
        gumbel=lambda i: gumbel_noise(gen, (batch, num_actions)),
    )


def random_planes(eng: TakEngine, ply: int, sym, pair, gumbel) -> torch.Tensor:
    """[B, C, N, N] planes of the random games of these draws: the standard
    two-corner-flats opening plus ``ply`` random steps (a finished game
    keeps its position)."""
    return planes_of(eng, make_new_opening(eng, random_steps=ply)(sym, pair, gumbel))


def random_plane_batch(eng: TakEngine, gen: torch.Generator, ply: int, batch: int) -> torch.Tensor:
    """[B, C, N, N] planes of random games at the given ply, on ``gen``'s
    device (eee/utils.rs ``reference_envs``; ply counts the random steps, as
    in Env::new_opening_with_random_steps).  One ply's draws live at a
    time."""
    return random_planes(eng, ply, **random_draws(gen, batch, eng.num_actions))


def replay_positions(eng: TakEngine, replay_file, device: torch.device, limit: int | None = None):
    """(states TakState[P] on the CPU, plies int32[P], tps list[str]) of every
    position of every replay, at most ``limit``, in JAX's order: replay by
    replay, each before every one of its actions.  The replays are stepped
    on ``device``.

    ``tps`` keys the uniqueness set by literal TPS, as JAX does (the
    reference keys canonical(), which only differs by board symmetry).  A
    line that is not a replay raises, as ``Replay.from_line`` does.
    """
    parts, count = [], 0
    for states, _ in read_replay_blocks(eng, replay_file, device):
        parts.append(states.map(lambda x: x.cpu()))
        count += states.ply.shape[0]
        if limit is not None and count >= limit:
            break
    states = TakState(*(torch.cat(xs) for xs in zip(*parts))) if parts else eng.initial(0)
    if limit is not None:
        states = states.map(lambda x: x[:limit])
    return states, states.ply.numpy(), states_to_tps(eng.n, states)


def unique_positions(states: TakState, plies: np.ndarray, keys) -> dict:
    """{ply: TakState[k]}: per ply, the positions whose key (their TPS) was
    not seen before, in stream order."""
    seen, first = set(), []
    for i, key in enumerate(keys):
        if key not in seen:
            seen.add(key)
            first.append(i)
    first = np.asarray(first, np.int64)
    out = {}
    for ply in np.unique(plies[first]):
        idx = torch.from_numpy(first[plies[first] == ply])
        out[int(ply)] = states.map(lambda x: x[idx])
    return out


def load_replay_positions(eng: TakEngine, replay_file, device: torch.device, limit: int | None = None):
    """(positions TakState[P], unique_by_ply {ply: TakState[k]}): the stream
    of :func:`replay_positions` and, per ply, its positions whose TPS was
    not seen before, in stream order (both on the CPU)."""
    states, plies, tps = replay_positions(eng, replay_file, device, limit)
    return states, unique_positions(states, plies, tps)


def reference_draws(gen: torch.Generator, eng: TakEngine, batch_size: int) -> dict:
    """The draws of :func:`reference_batches` from ``gen``: a numpy seed for
    the replay pools' picks and one :func:`random_draws` per batch."""
    seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=gen.device).item())
    return {"seed": seed, **{name: random_draws(gen, batch_size, eng.num_actions) for name in REF_NAMES}}


def reference_batches(
    eng: TakEngine,
    unique_by_ply: dict,
    draws: dict,
    batch_size: int,
    early_ply: int = 8,
    late_ply: int = 60,
    sources: dict | None = None,
) -> dict:
    """dict of plane batches on the draws' device: early/late (replay),
    random_early/late, impossible_early.

    ``unique_by_ply`` maps a ply to its pool of unique replay positions
    (a CPU ``TakState``); a pool of at least ``batch_size`` is sampled
    without replacement by ``default_rng(draws["seed"]).choice``, as JAX
    does, and a smaller one falls back to random games at the same ply from
    ``draws[name]``.  ``sources``, if given, receives where early and late
    came from.
    """
    dev = draws["random_early"]["sym"].device
    rng = np.random.default_rng(draws["seed"])
    out = {}
    for name, ply in (("early", early_ply), ("late", late_ply)):
        pool = unique_by_ply.get(ply)
        size = 0 if pool is None else int(pool.ply.shape[0])
        if size >= batch_size:
            picks = torch.from_numpy(rng.choice(size, batch_size, replace=False))
            out[name] = planes_of(eng, pool.map(lambda x: x[picks].to(dev)))
            where = "replay pool"
        else:
            out[name] = random_planes(eng, ply, **draws[name])
            where = "random games"
        if sources is not None:
            sources[name] = {"ply": ply, "from": where, "unique_positions": size}
    out["random_early"] = random_planes(eng, early_ply, **draws["random_early"])
    out["random_late"] = random_planes(eng, late_ply, **draws["random_late"])
    # An INDEPENDENT third random batch, as in the reference
    # (eee/utils.rs:78 draws fresh reference_envs before permuting).
    perm = torch.from_numpy(impossible_permutation(eng.n)).to(dev).long()
    out["impossible_early"] = random_planes(eng, early_ply, **draws["impossible_early"])[:, perm]
    return out


class ForcedUsesBuffer:
    """The training buffer of the replay experiments (rnd.rs:24-28): refilled
    from the position stream (recycled when it runs out) to at least
    ``max(1024, batch_size)`` entries, shuffled by ``rng``, the last
    ``batch_size`` taken, and each put back with one use less until
    ``forced_uses`` are spent.  The same ``rng`` calls as JAX's loop, over
    position indices."""

    def __init__(self, count: int, rng: np.random.Generator, batch_size: int, forced_uses: int):
        if count == 0:
            raise ValueError("the replay stream holds no positions")
        self.count, self.rng, self.batch_size, self.forced_uses = count, rng, batch_size, forced_uses
        self.buffer: list = []
        self.next = 0

    def take(self) -> np.ndarray:
        """int64[batch_size] position indices of the next training batch."""
        while len(self.buffer) < max(1024, self.batch_size):
            self.buffer.append([self.next, self.forced_uses])
            self.next = (self.next + 1) % self.count
        self.rng.shuffle(self.buffer)
        batch = self.buffer[-self.batch_size :]
        del self.buffer[-self.batch_size :]
        self.buffer.extend([i, u - 1] for i, u in batch if u > 1)
        return np.array([i for i, _ in batch], np.int64)
