"""Target-line parsing, replay explosion and training-batch assembly.

Counterpart of the functions of ``takzero_tpu/data/native_loader.py``
that the learner and reanalyze call, under the same names.  The JAX
package parses with its C++ library (``takzero_tpu/cpp/tak_io.cpp``); the
port parses in Python through its own ``tak/tps.py`` and ``tak/moves.py``
and keeps the reference's tolerance: a malformed line is dropped, not
raised.  Replays are exploded by stepping all replays of one read together
on the port's engine, one batched ``step`` per ply.

``make_batch_native`` draws one symmetry per target exactly as the JAX
function does (``rng.integers(0, 8, size=t)`` on a numpy ``Generator``),
so the same seed gives the same batch in both packages.  The states are
permuted on the host; the dense policy, the mask and the input planes are
built on the batch's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.target import RESULTS, Replay
from ..device import resolve_device
from ..ops.repr import scatter_policy, state_to_planes
from ..tak.moves import ptn_to_action
from ..tak.state import TakState, initial_state_batch
from ..tak.symmetry import action_maps, transform_state
from ..tak.engine import engine
from ..tak.tps import states_to_tps, tps_fields
from ..train.learner import Batch


def state_size(n: int) -> int:
    """Columns of a packed position row (``pack_rows``, ``unpack_states``)."""
    return 3 * n * n + 7


def unpack_states(n: int, buf: np.ndarray) -> TakState:
    """int64[T, state_size] rows -> batched TakState on the CPU.

    A row is height [S], the int64 colour fields [S], tops [S], reserves
    [4], to_move, ply, reversible: the JAX package's layout, whose colour
    column holds the same 64 bits.
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


@functools.lru_cache(maxsize=1 << 16)
def _action(n: int, move: str) -> int:
    return ptn_to_action(n, move)


def _parse_line(n: int, line: str):
    """(state fields, value, ube, actions, probs) of one line; raises on a
    malformed one (the rules of ``Target.from_line``)."""
    tps, value, ube, pol = line.split(";")
    actions, probs = [], []
    for item in pol.split(","):
        mv, p = item.rsplit(":", 1)
        actions.append(_action(n, mv))
        probs.append(float(p))
    return tps_fields(n, tps), float(value), float(ube), actions, probs


def parse_targets(n: int, text: str, return_lines: bool = False):
    """-> (states TakState[T] on the CPU, value[T], ube[T], actions, probs,
    offsets[T+1] [, line_numbers[T]]).

    Malformed lines are skipped, matching the learner's tolerance; blank
    lines are skipped and still counted in the line numbers.
    """
    fields, value, ube, actions, probs, offsets, line_numbers = [], [], [], [], [], [0], []
    for i, raw in enumerate(text.split("\n")):
        line = raw.rstrip("\r ")
        if not line:
            continue
        try:
            f, v, u, acts, ps = _parse_line(n, line)
        except (ValueError, IndexError):
            continue
        fields.append(f)
        value.append(v)
        ube.append(u)
        actions += acts
        probs += ps
        offsets.append(len(actions))
        line_numbers.append(i)
    if fields:
        states = TakState(**{k: torch.from_numpy(np.stack([f[k] for f in fields])) for k in TakState._fields})
    else:
        states = initial_state_batch(n, 0)
    out = (
        states,
        np.asarray(value, np.float32),
        np.asarray(ube, np.float32),
        np.asarray(actions, np.int32),
        np.asarray(probs, np.float32),
        np.asarray(offsets, np.int64),
    )
    return out + (np.asarray(line_numbers, np.int32),) if return_lines else out


def valid_target_lines(n: int, lines: list[str]) -> list[str]:
    """Filter to the lines the parser accepts (ingestion-time check)."""
    if not lines:
        return []
    text = "\n".join(line.rstrip("\n") for line in lines) + "\n"
    *_, idx = parse_targets(n, text, return_lines=True)
    return [lines[i] for i in idx]


def _parse_replay(n: int, raw: str):
    """(start TPS fields, actions) of one replay line, or None where the
    C++ parser (``tak_parse_replays``) skips the line: no ``[TPS "..."]``
    head, a bad TPS, or a bad move token.  Tokens end at a result."""
    line = raw.rstrip("\r ")
    if len(line) <= 8 or not line.startswith('[TPS "'):
        return None
    end = line.find('"]', 6)
    if end < 0:
        return None
    try:
        fields = tps_fields(n, line[6:end])
        actions = []
        for tok in line[end + 2 :].split(" "):
            if not tok:
                continue
            if tok in RESULTS:
                break
            actions.append(_action(n, tok))
    except (ValueError, IndexError):
        return None
    return fields, actions


def parse_replay_positions(n: int, half_komi: int, reversible_limit: int, text: str):
    """Explode replay lines into the position before every action.

    -> (states TakState[P] on the CPU, plies int32[P]), in replay order,
    then in ply order (reference reanalyze/src/main.rs:269-290).  All
    replays are stepped together: one batched ``eng.step`` per ply.
    """
    eng = engine(n, half_komi=half_komi, reversible_limit=reversible_limit)
    parsed = [p for p in (_parse_replay(n, raw) for raw in text.split("\n")) if p is not None]
    states = explode_replays(eng, parsed, torch.device("cpu"))
    return states, states.ply.numpy()


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
