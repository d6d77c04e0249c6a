"""Target lines: the learner's wire format.

The port's own copy of ``Target`` from ``takzero_tpu/data/target.py``,
byte for byte: a target line is

    {tps};{value};{ube};{move}:{p},{move}:{p},...

These lines are shared between processes of both packages (selfplay and
reanalyze append them, the learner tails them), so ``to_line`` prints
what the JAX package prints and ``from_line`` reads what it reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tak.moves import action_to_ptn, ptn_to_action


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
