"""Target-line parsing and training-batch assembly.

Counterpart of the functions of ``takzero_tpu/data/native_loader.py``
that the learner calls, under the same names.  The JAX package parses
with its C++ library (``takzero_tpu/cpp/tak_io.cpp``); the port parses in
Python through its own ``tak/tps.py`` and ``data/target.py`` and keeps the
reference learner's tolerance: a malformed line is dropped, not raised.

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

from ..device import resolve_device
from ..ops.repr import scatter_policy, state_to_planes
from ..tak.moves import ptn_to_action
from ..tak.state import TakState, initial_state_batch
from ..tak.symmetry import action_maps, transform_state
from ..tak.tps import tps_fields
from ..train.learner import Batch


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
