"""ctypes binding of the port's C++ rules oracle (``takzero_torch/cpp/``).

Counterpart of ``takzero_tpu/tak/oracle.py``.  The oracle is an
independent implementation of the rules (explicit stacks, recursive road
search) with an exact tinue solver; the tests fuzz the port's engine
against it, and the puzzle tools verify with it.  The library is the
port's own copy of the sources, built on first use into ``build/`` by
``ops/_cpp_build.py``.

It works on ONE position: a :class:`TakState` whose fields have no batch
dimension, as host tensors (``tps_to_state`` gives one; a batched state
gives one with ``state.map(lambda x: x[b].cpu())``).  The C++ buffer holds
``3 * n * n + 7`` int64: heights, owners, tops, reserves, to_move, ply,
reversible.  The port's ``owner`` is one int64 per square already, so
packing copies it (JAX splits it into two uint32 lanes and joins them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import _cpp_build
from .moves import action_space
from .state import TakState, initial_state_batch
from .symmetry import square_maps

_I, _I64, _U64 = ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
# symbol -> (argtypes after (n, half_komi, reversible_limit), restype)
_SIGNATURES = {
    "tak_legal_mask": ([_P64, ctypes.POINTER(ctypes.c_uint8)], None),
    "tak_step": ([_P64, _I], None),
    "tak_result": ([_P64], _I),
    "tak_random_playout": ([_P64, _U64, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
    "tak_tinue_depth": ([_P64, _I, _I64], _I),
    "tak_loses_within": ([_P64, _I, _I64], _I),
    "tak_avoidance_status": ([_P64, _I, _I64, _P32], None),
    "tak_avoidance_status_laddered": ([_P64, _I, _I64, _I64, _P32], None),
}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_cpp_build.build("tak_oracle")))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_I, _I, _I, *args]
        fn.restype = res
    return lib


def _state_size(n: int) -> int:
    return 3 * n * n + 7


def pack_state(n: int, state: TakState) -> np.ndarray:
    s = n * n
    buf = np.zeros(_state_size(n), dtype=np.int64)
    buf[:s] = np.asarray(state.height)
    buf[s : 2 * s] = np.asarray(state.owner, dtype=np.int64)
    buf[2 * s : 3 * s] = np.asarray(state.tops)
    buf[3 * s : 3 * s + 4] = np.asarray(state.reserves).reshape(-1)
    buf[3 * s + 4] = int(state.to_move)
    buf[3 * s + 5] = int(state.ply)
    buf[3 * s + 6] = int(state.reversible)
    return buf


def unpack_state(n: int, buf: np.ndarray) -> TakState:
    s = n * n
    i32 = lambda x: torch.from_numpy(np.array(x, dtype=np.int32))  # noqa: E731
    return TakState(
        height=i32(buf[:s]),
        owner=torch.from_numpy(buf[s : 2 * s].copy()),
        tops=i32(buf[2 * s : 3 * s]),
        reserves=i32(buf[3 * s : 3 * s + 4].reshape(2, 2)),
        to_move=i32(buf[3 * s + 4]),
        ply=i32(buf[3 * s + 5]),
        reversible=i32(buf[3 * s + 6]),
    )


def _ptr(buf: np.ndarray, ctype):
    return buf.ctypes.data_as(ctypes.POINTER(ctype))


class Oracle:
    def __init__(self, n: int, half_komi: int = 0, reversible_limit: int = 50):
        self.n = n
        self.half_komi = half_komi
        self.reversible_limit = reversible_limit
        self.num_actions = action_space(n).num_actions
        self._lib = _lib()

    def _args(self):
        return (self.n, self.half_komi, self.reversible_limit)

    def legal_mask(self, state: TakState) -> np.ndarray:
        buf = pack_state(self.n, state)
        out = np.zeros(self.num_actions, dtype=np.uint8)
        self._lib.tak_legal_mask(*self._args(), _ptr(buf, ctypes.c_int64), _ptr(out, ctypes.c_uint8))
        return out.astype(bool)

    def step(self, state: TakState, action: int) -> TakState:
        buf = pack_state(self.n, state)
        self._lib.tak_step(*self._args(), _ptr(buf, ctypes.c_int64), int(action))
        return unpack_state(self.n, buf)

    def result(self, state: TakState) -> int:
        """-1 ongoing, 0 white wins, 1 black wins, 2 draw."""
        buf = pack_state(self.n, state)
        return self._lib.tak_result(*self._args(), _ptr(buf, ctypes.c_int64))

    def random_playout(self, state: TakState, seed: int, max_plies: int = 400) -> tuple[TakState, list[int], int]:
        """Fast in-oracle random game; returns (final_state, actions, result)."""
        buf = pack_state(self.n, state)
        actions = np.zeros(max_plies, dtype=np.int32)
        res = ctypes.c_int(-1)
        plies = self._lib.tak_random_playout(
            *self._args(), _ptr(buf, ctypes.c_int64), seed, max_plies, _ptr(actions, ctypes.c_int), ctypes.byref(res)
        )
        return unpack_state(self.n, buf), actions[:plies].tolist(), res.value

    def tinue_depth(self, state: TakState, max_depth: int, node_budget: int = 50_000_000) -> int:
        """Minimal odd d <= max_depth such that the side to move forces a
        win (exact full-width search, cpp/tak_solver.cpp); 0 if none, -1
        if the node budget was exhausted (unknown)."""
        buf = pack_state(self.n, state)
        return self._lib.tak_tinue_depth(*self._args(), _ptr(buf, ctypes.c_int64), int(max_depth), int(node_budget))

    def loses_within(self, state: TakState, depth: int, node_budget: int = 50_000_000) -> int:
        """1 if the side to move is LOST within `depth` plies (every move
        leads to a forced opponent win), 0 if not, -1 if unknown."""
        buf = pack_state(self.n, state)
        return self._lib.tak_loses_within(*self._args(), _ptr(buf, ctypes.c_int64), int(depth), int(node_budget))

    def avoidance_status(self, state: TakState, max_depth: int, node_budget: int = 50_000_000) -> np.ndarray:
        """Per-action labels: -1 illegal, -2 survives, -3 unknown, k >= 0
        the opponent forces a win in minimally k plies after the move."""
        buf = pack_state(self.n, state)
        out = np.zeros(self.num_actions, dtype=np.int32)
        self._lib.tak_avoidance_status(
            *self._args(), _ptr(buf, ctypes.c_int64), int(max_depth), int(node_budget), _ptr(out, ctypes.c_int32)
        )
        return out

    def avoidance_status_laddered(
        self, state: TakState, max_depth: int, small_budget: int, node_budget: int
    ) -> np.ndarray:
        """`avoidance_status` with a budget ladder and two-survivor early
        exit: moves solve at `small_budget` first, unknowns retry at
        `node_budget`, and the search bails once two survivors are proven
        (remaining labels may be stale — check the survivor count FIRST)."""
        buf = pack_state(self.n, state)
        out = np.zeros(self.num_actions, dtype=np.int32)
        self._lib.tak_avoidance_status_laddered(
            *self._args(), _ptr(buf, ctypes.c_int64), int(max_depth), int(small_budget), int(node_budget),
            _ptr(out, ctypes.c_int32),
        )
        return out


def initial_state(n: int) -> TakState:
    """The start position as one host lane."""
    return initial_state_batch(n, 1).map(lambda x: x[0])


def oracle_opening(orc: Oracle, rng: np.random.Generator) -> TakState:
    """The reference opening (two corner flats under a symmetry) on the
    oracle: one ``rng.integers(0, 8)``, one ``rng.integers(0, 2)``, two
    steps, in the order of JAX's ``train/data.py`` ``_host_opening``, so a
    numpy seed gives JAX's opening."""
    n = orc.n
    sqm = square_maps(n)
    sym = int(rng.integers(0, 8))
    pair = int(rng.integers(0, 2))
    a1, an, xn = 0, (n - 1) * n, (n - 1) * n + (n - 1)
    state = initial_state(n)
    for sq in ([a1, an] if pair == 0 else [a1, xn]):
        state = orc.step(state, int(sqm[sym, sq]))
    return state
