"""Target-line parsing, replay explosion and training-batch assembly.

Counterpart of ``takzero_tpu/data/native_loader.py``, under the same
names.  As there, the wire formats are parsed by the C++ loader
(``cpp/tak_io.cpp``, the port's copy, linked into ``libtak_oracle`` by
``ops/_cpp_build.py``) through ctypes: target lines, replay explosion into
the position before every action (stepped by the C++ rules core), and one
TPS or PTN move.  A malformed line is dropped, not raised; a replay with a
bad move token is dropped whole.  ``explode_replays`` steps parsed
replays on a device instead, for the paths that need the positions there
(EEE, the replay visualizers).

``make_batch_native`` draws one symmetry per target exactly as the JAX
function does (``rng.integers(0, 8, size=t)`` on a numpy ``Generator``),
so the same seed gives the same batch in both packages.  The states are
permuted on the host; the dense policy, the mask and the input planes are
built on the batch's device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..data.target import Replay
from ..device import resolve_device
from ..ops import _cpp_build
from ..ops.repr import scatter_policy, state_to_planes
from ..tak.state import TakState, initial_state_batch
from ..tak.symmetry import action_maps, transform_state
from ..tak.tps import states_to_tps, tps_fields
from ..train.learner import Batch

_I, _L, _CP = ctypes.c_int, ctypes.c_long, ctypes.c_char_p
_P64, _P32, _PF = (ctypes.POINTER(t) for t in (ctypes.c_int64, ctypes.c_int32, ctypes.c_float))
# name -> (argtypes, restype): ``takzero_tpu/data/native_loader.py``'s.
_SIGNATURES = {
    "tak_parse_tps": ([_I, _CP, _L, _P64], _I),
    "tak_parse_ptn": ([_I, _CP, _L], _I),
    "tak_parse_targets": ([_I, _CP, _L, _I, _L, _P64, _PF, _PF, _P32, _PF, _P64, _P32], _I),
    "tak_parse_replays": ([_I, _I, _I, _CP, _L, _L, _P64, _P32], _I),
}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_cpp_build.build("tak_oracle")))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _ptr(x: np.ndarray, kind):
    return x.ctypes.data_as(kind)


def state_size(n: int) -> int:
    """Columns of a packed position row (``pack_rows``, ``unpack_states``)."""
    return 3 * n * n + 7


def unpack_states(n: int, buf: np.ndarray) -> TakState:
    """int64[T, state_size] rows -> batched TakState on the CPU.

    A row is height [S], the int64 colour fields [S], tops [S], reserves
    [4], to_move, ply, reversible: the C++ loader's layout, whose colour
    column holds the same 64 bits as the JAX package's lo/hi pair.
    """
    s = n * n
    buf = torch.from_numpy(np.ascontiguousarray(buf, np.int64).reshape(-1, state_size(n)))
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return TakState(
        height=i32(buf[:, :s]),
        owner=buf[:, s : 2 * s].contiguous(),
        tops=i32(buf[:, 2 * s : 3 * s]),
        reserves=i32(buf[:, 3 * s : 3 * s + 4]).reshape(-1, 2, 2),
        to_move=i32(buf[:, 3 * s + 4]),
        ply=i32(buf[:, 3 * s + 5]),
        reversible=i32(buf[:, 3 * s + 6]),
    )


def parse_tps(n: int, tps: str) -> TakState:
    """One position (tensors without a batch dimension) from its TPS, by
    the C++ parser; raises ``ValueError`` on a bad TPS."""
    buf = np.zeros(state_size(n), np.int64)
    raw = tps.encode()
    if _lib().tak_parse_tps(n, raw, len(raw), _ptr(buf, _P64)) != 0:
        raise ValueError(f"bad TPS: {tps!r}")
    return unpack_states(n, buf[None]).map(lambda x: x[0])


def parse_ptn(n: int, ptn: str) -> int:
    """The action of one PTN move, by the C++ parser; raises ``ValueError``
    on a bad move."""
    raw = ptn.encode()
    a = _lib().tak_parse_ptn(n, raw, len(raw))
    if a < 0:
        raise ValueError(f"bad PTN move: {ptn!r}")
    return a


def parse_targets(n: int, text: str, max_targets: int | None = None, return_lines: bool = False):
    """-> (states TakState[T] on the CPU, value[T], ube[T], actions, probs,
    offsets[T+1] [, line_numbers[T]]), at most ``max_targets`` targets
    (default: one a line).

    Malformed lines are skipped, matching the learner's tolerance; blank
    lines are skipped and still counted in the line numbers.
    """
    raw = text.encode()
    if max_targets is None:
        max_targets = text.count("\n") + 1
    cap_policy = max(1, len(raw) // 4)  # every policy item is >= 4 bytes
    states = np.zeros((max_targets, state_size(n)), np.int64)
    value = np.zeros(max_targets, np.float32)
    ube = np.zeros(max_targets, np.float32)
    actions = np.zeros(cap_policy, np.int32)
    probs = np.zeros(cap_policy, np.float32)
    offsets = np.zeros(max_targets + 1, np.int64)
    lines = np.zeros(max_targets, np.int32)
    t = _lib().tak_parse_targets(
        n, raw, len(raw), max_targets, cap_policy, _ptr(states, _P64), _ptr(value, _PF), _ptr(ube, _PF),
        _ptr(actions, _P32), _ptr(probs, _PF), _ptr(offsets, _P64), _ptr(lines, _P32),
    )
    end = int(offsets[t])
    out = (unpack_states(n, states[:t]), value[:t], ube[:t], actions[:end], probs[:end], offsets[: t + 1])
    return out + (lines[:t],) if return_lines else out


def valid_target_lines(n: int, lines: list[str]) -> list[str]:
    """Filter to the lines the parser accepts (ingestion-time check)."""
    if not lines:
        return []
    text = "\n".join(line.rstrip("\n") for line in lines) + "\n"
    *_, idx = parse_targets(n, text, return_lines=True)
    return [lines[i] for i in idx]


def parse_replay_rows(n: int, half_komi: int, reversible_limit: int, text: str,
                      cap_positions: int | None = None):
    """Explode replay lines into the position before every action, by the
    C++ loader: -> (int64[P, state_size] rows, plies int32[P]), in replay
    order, then in ply order (reference reanalyze/src/main.rs:269-290).
    A line with no ``[TPS "..."]`` head, a bad TPS or a bad move token
    gives nothing."""
    raw = text.encode()
    if cap_positions is None:
        cap_positions = max(16, len(raw) // 2)  # at most one position per 3 bytes of move text
    rows = np.zeros((cap_positions, state_size(n)), np.int64)
    plies = np.zeros(cap_positions, np.int32)
    p = _lib().tak_parse_replays(n, half_komi, reversible_limit, raw, len(raw), cap_positions,
                                 _ptr(rows, _P64), _ptr(plies, _P32))
    return rows[:p].copy(), plies[:p].copy()  # not views that hold the whole capacity


def parse_replay_positions(n: int, half_komi: int, reversible_limit: int, text: str,
                           cap_positions: int | None = None):
    """:func:`parse_replay_rows` as (states TakState[P] on the CPU, plies
    int32[P])."""
    rows, plies = parse_replay_rows(n, half_komi, reversible_limit, text, cap_positions)
    return unpack_states(n, rows), plies


def explode_replays(eng, parsed, device: torch.device) -> TakState:
    """The position before every action of each replay, on ``device``.

    ``parsed`` lists (start TPS fields, actions) pairs; replays without an
    action give nothing.  Positions come in replay order, then in ply
    order; all replays are stepped together, one batched ``eng.step`` per
    ply.
    """
    parsed = [p for p in parsed if p[1]]
    if not parsed:
        return initial_state_batch(eng.n, 0).map(lambda x: x.to(device))
    lengths = np.array([len(a) for _, a in parsed])
    plies = int(lengths.max())
    state = TakState(**{k: torch.from_numpy(np.stack([f[k] for f, _ in parsed])).to(device) for k in TakState._fields})
    actions = np.zeros((len(parsed), plies), np.int64)
    for i, (_, acts) in enumerate(parsed):
        actions[i, : len(acts)] = acts
    actions = torch.from_numpy(actions).to(device)
    snapshots = []  # TakState[L] before ply j, for j < plies
    for j in range(plies):
        snapshots.append(state)
        if j + 1 < plies:
            state = eng.step(state, actions[:, j])
    stacked = TakState(*(torch.stack(x) for x in zip(*snapshots)))  # [plies, L, ...]
    line = np.repeat(np.arange(len(parsed)), lengths)
    ply = np.concatenate([np.arange(k) for k in lengths])
    li, pi = torch.from_numpy(line).to(device), torch.from_numpy(ply).to(device)
    return stacked.map(lambda x: x[pi, li])


def read_replay_blocks(eng, path, device: torch.device, block: int = 4096):
    """Yield (states TakState[P] on ``device``, lengths int[L]) per block of
    up to ``block`` non-empty lines of a replay file, in file order: the
    position before every action of each of the block's L replays
    (:func:`explode_replays`, stepped on ``device``) and how many belong to
    each line.  A line that is not a replay raises, as ``Replay.from_line``
    does."""
    with open(path, "r", encoding="utf-8") as f:
        lines = (line.strip() for line in f)
        while True:
            chunk = []
            for line in lines:
                if line:
                    chunk.append(Replay.from_line(eng.n, line))
                    if len(chunk) == block:
                        break
            if not chunk:
                return
            states = explode_replays(eng, [(tps_fields(eng.n, r.tps), r.actions) for r in chunk], device)
            yield states, np.array([len(r.actions) for r in chunk], np.int64)


def replay_line_tps(eng, path, device: torch.device, block: int = 4096):
    """Yield, per non-empty line of a replay file in order, the TPS of the
    position before each of its actions (a list, empty for a replay
    without actions).  The replays are stepped on ``device``; only the
    positions come back to the host for their TPS."""
    for states, lengths in read_replay_blocks(eng, path, device, block):
        tps = states_to_tps(eng.n, states.map(lambda x: x.cpu()))
        for start, stop in zip(np.cumsum(lengths) - lengths, np.cumsum(lengths)):
            yield tps[start:stop]


def augment_states(n: int, states: TakState, syms: np.ndarray) -> TakState:
    """Apply per-row symmetries ``syms`` [T] to a batched state."""
    return transform_state(n, states, torch.as_tensor(np.asarray(syms, np.int64)))


def make_batch_native(eng, text: str, rng: np.random.Generator, augment=True,
                      splits: int | None = None, device=None) -> Batch:
    """Parse target lines and build a training :class:`Batch` on ``device``
    (default ``cuda``; raises without CUDA).

    With ``splits=c`` the text holds ``c`` consecutive batches and every
    leaf comes back with a leading ``[c, T//c, ...]`` chunk axis (the layout
    ``make_train_step_chunk`` consumes), from one parse and one transfer.
    """
    dev = resolve_device(device)
    n = eng.n
    a = eng.num_actions
    states, value, ube, actions, probs, offsets = parse_targets(n, text)
    t = value.shape[0]
    if t == 0:
        raise ValueError("no targets parsed")
    if splits is not None and t % splits:
        raise ValueError(f"{t} targets not divisible by splits={splits}")
    syms = rng.integers(0, 8, size=t).astype(np.int32) if augment else np.zeros(t, np.int32)
    states = augment_states(n, states, syms)
    item_row = np.repeat(np.arange(t), np.diff(offsets)).astype(np.int32)
    mapped = action_maps(n)[syms[item_row], actions].astype(np.int32)
    policy, mask = scatter_policy(t, a, item_row, mapped, probs, dev)
    planes = state_to_planes(eng, states.map(lambda x: x.to(dev)))
    batch = Batch(
        planes=planes,
        policy=policy,
        mask=mask,
        value=torch.from_numpy(value).to(dev),
        ube=torch.from_numpy(ube).to(dev),
    )
    if splits is None:
        return batch
    return Batch(*(x.reshape((splits, t // splits) + x.shape[1:]) for x in batch))
