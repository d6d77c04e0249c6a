"""Bradley-Terry Elo fit of match results.

The port's copy of ``takzero_tpu/tools/elo.py`` (reference python/elo.py),
numpy only: Hunter's MM algorithm, draws counted as half a win for each
side, a small uniform prior for connectivity, and standard errors from the
Fisher information.  Ratings are relative (mean 0).  ``tiny_run`` reports
its Elo through :func:`fit_elo`.

CSV line format (python/get_match_results.py):
    <white>, <white_steps>, <black>, <black_steps>, <wins>, <losses>, <draws>
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

ELO_PER_NAT = 400.0 / math.log(10.0)


@dataclass
class MatchResult:
    white: str
    white_steps: int
    black: str
    black_steps: int
    wins: int
    losses: int
    draws: int

    @staticmethod
    def from_line(line: str) -> "MatchResult":
        white, ws, black, bs, w, l, d = [x.strip() for x in line.split(",")]
        return MatchResult(white, int(ws), black, int(bs), int(w), int(l), int(d))

    def white_name(self) -> str:
        return name(self.white, self.white_steps)

    def black_name(self) -> str:
        return name(self.black, self.black_steps)


def name(model: str, steps: int) -> str:
    return f"{model}_{steps}"


def read_results(*paths) -> list[MatchResult]:
    results: list[MatchResult] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    results.append(MatchResult.from_line(line))
    return results


def fit_elo(
    matches: list[MatchResult],
    iterations: int = 2_000,
    prior_games: float = 0.5,
    tol: float = 1e-9,
) -> dict[str, tuple[float, float]]:
    """{player: (elo, stderr)} — Bradley-Terry MM fit, mean-0 anchored.

    `prior_games` adds that many virtual drawn games between every player
    and a virtual mean-strength opponent, keeping the fit finite for
    players with perfect scores and disconnected groups.
    """
    players = sorted(
        {m.white_name() for m in matches} | {m.black_name() for m in matches}
    )
    idx = {p: i for i, p in enumerate(players)}
    p = len(players)
    # wins[i, j] = (possibly fractional) wins of i over j.
    wins = np.zeros((p, p))
    for m in matches:
        i, j = idx[m.white_name()], idx[m.black_name()]
        wins[i, j] += m.wins + 0.5 * m.draws
        wins[j, i] += m.losses + 0.5 * m.draws
    games = wins + wins.T

    gamma = np.ones(p)
    w_total = wins.sum(axis=1) + prior_games / 2.0
    for _ in range(iterations):
        # Virtual opponent has strength = geometric mean of gamma = 1 after
        # each renormalization.
        denom = (games / (gamma[:, None] + gamma[None, :])).sum(axis=1)
        denom = denom + prior_games / (gamma + 1.0)
        new_gamma = w_total / np.maximum(denom, 1e-30)
        new_gamma = new_gamma / np.exp(np.mean(np.log(new_gamma)))  # anchor
        if np.max(np.abs(np.log(new_gamma) - np.log(gamma))) < tol:
            gamma = new_gamma
            break
        gamma = new_gamma

    # Fisher information in the log-strength parametrization.
    pij = gamma[:, None] / (gamma[:, None] + gamma[None, :])
    info = (games * pij * (1.0 - pij)).sum(axis=1)
    info = info + prior_games * (gamma / (gamma + 1.0)) * (1.0 / (gamma + 1.0))
    stderr = ELO_PER_NAT / np.sqrt(np.maximum(info, 1e-30))
    elo = ELO_PER_NAT * np.log(gamma)
    return {pl: (float(elo[i]), float(stderr[i])) for pl, i in idx.items()}


def elo_curves(matches: list[MatchResult]):
    """{model: [(steps, elo, stderr)]} sorted by steps — for plotting."""
    ratings = fit_elo(matches)
    models = sorted({m.white for m in matches} | {m.black for m in matches})
    curves = {}
    for model in models:
        steps = sorted(
            {m.white_steps for m in matches if m.white == model}
            | {m.black_steps for m in matches if m.black == model}
        )
        curves[model] = [(s, *ratings[name(model, s)]) for s in steps]
    return curves
