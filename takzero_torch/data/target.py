"""Target and replay lines: the actors' and the learner's wire formats.

The port's own copy of ``takzero_tpu/data/target.py``, byte for byte:

* target line: ``{tps};{value};{ube};{move}:{p},{move}:{p},...``
* replay line: ``[TPS "{tps}"] {move} {move} ... {result}``

These lines are shared between processes of both packages (selfplay and
reanalyze append them, the learner and reanalyze tail them), so
``to_line`` prints what the JAX package prints and ``from_line`` reads
what it reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..tak.engine import TakEngine
from ..tak.moves import action_to_ptn, ptn_to_action
from ..tak.tps import tps_to_state

RESULTS = ("R-0", "0-R", "F-0", "0-F", "1/2-1/2", "1-0", "0-1")


@dataclass
class Target:
    tps: str
    value: float
    ube: float
    policy: list  # [(action_index, probability)]
    n: int

    def to_line(self) -> str:
        pol = ",".join(f"{action_to_ptn(self.n, a)}:{_fmt(p)}" for a, p in self.policy)
        return f"{self.tps};{_fmt(self.value)};{_fmt(self.ube)};{pol}"

    @classmethod
    def from_line(cls, n: int, line: str) -> "Target":
        tps, value, ube, pol = line.strip().split(";")
        policy = []
        for item in pol.split(","):
            mv, p = item.rsplit(":", 1)
            policy.append((ptn_to_action(n, mv), float(p)))
        return cls(tps=tps, value=float(value), ube=float(ube), policy=policy, n=n)

    def state(self):
        return tps_to_state(self.n, self.tps)


@dataclass
class Replay:
    tps: str  # starting position
    actions: list = field(default_factory=list)  # action indices
    result: str = ""  # PTN result string, may be empty
    n: int = 6

    def to_line(self) -> str:
        moves = " ".join(action_to_ptn(self.n, a) for a in self.actions)
        parts = [f'[TPS "{self.tps}"]']
        if moves:
            parts.append(moves)
        if self.result:
            parts.append(self.result)
        return " ".join(parts)

    @classmethod
    def from_line(cls, n: int, line: str) -> "Replay":
        line = line.strip()
        if not line.startswith('[TPS "'):
            raise ValueError(f"not a replay line: {line!r}")
        end = line.index('"]')
        tps = line[len('[TPS "') : end]
        rest = line[end + 2 :].split()
        result = ""
        if rest and rest[-1] in RESULTS:
            result = rest[-1]
            rest = rest[:-1]
        actions = [ptn_to_action(n, mv) for mv in rest]
        return cls(tps=tps, actions=actions, result=result, n=n)

    def states(self, eng: TakEngine) -> list:
        """Every position before each action (reference target.rs:205-212),
        as unbatched CPU states, replayed on the port's engine."""
        state = tps_to_state(self.n, self.tps).map(lambda x: x[None])
        out = []
        for a in self.actions:
            out.append(state.map(lambda x: x[0]))
            state = eng.step(state, torch.tensor([a]))
        return out


def _fmt(x: float) -> str:
    """Shortest float32 decimal (Rust Display-like: 4 -> "4", 0.997 -> "0.997").

    Values are float32 on the wire both ways, so the shortest string that
    round-trips float32 is printed.  NaN and inf print as text instead of
    raising, so that a diverged network cannot kill a writer mid-batch.
    """
    f = np.float32(x)
    if np.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return np.format_float_positional(f, unique=True, trim="0")


def pad_policy_with_legal(policy: list, legal_mask) -> list:
    """Append zero-probability entries for the legal actions missing from
    ``policy``.  The reference stores all children, so its target lines
    list exactly every legal action (target.rs:123-134); a child-truncated
    root stores only the top-C children, so the rest are padded."""
    have = {a for a, _ in policy}
    pad = [(int(a), 0.0) for a in np.flatnonzero(np.asarray(legal_mask)) if int(a) not in have]
    return policy + pad


def result_str_from(res: int, road: bool) -> str:
    """PTN result from (winner colour, won by a road): R-0/0-R roads,
    F-0/0-F flats, 1/2-1/2 draws."""
    if res == 2:
        return "1/2-1/2"
    if res == 0:
        return "R-0" if road else "F-0"
    return "0-R" if road else "0-F"


def result_string(eng: TakEngine, state) -> str:
    """PTN result of one unbatched terminal state ("" while ongoing)."""
    batched = state.map(lambda x: torch.as_tensor(x)[None])
    res = int(eng.game_result(batched)[0])
    if res == -1:
        return ""
    roads = eng._roads(batched)[0]
    return result_str_from(res, bool(roads[res]) if res in (0, 1) else False)
