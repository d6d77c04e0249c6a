"""Offline search-quality analysis over root-table dumps
(reference python/analyze_search.py + improved_policy.py).

The port's copy of ``takzero_tpu/tools/analyze_search.py`` (host code only).

Dump format (one root per line, produced by the selfplay driver's
``--dump-search`` and the analysis REPL):

    move:visits:eval:std:logit,move:visits:eval:std:logit,...

where ``eval`` is the child's eval from the CHILD's own view ("Win(3)",
"Loss(2)", "Draw(5)" or a float) exactly as dump_root_line writes it;
``parse_line`` negates it into the parent's view for the q/best stats.
Reports, per file:

* how often the most-visited move is also the best by q + beta*sigma;
* mean picked value and mean best value+uncertainty;
* agreement between the sigma_select variants used during sequential
  halving (q*(50+N), q*N, q*sqrt(N), 0.5*q*sqrt(N)).
"""

from __future__ import annotations

import math

import numpy as np


def to_value(s: str) -> float:
    if "Win" in s:
        return 1.0
    if "Loss" in s:
        return -1.0
    if "Draw" in s:
        return 0.0
    return float(s)


def parse_line(line: str):
    """[(move, visits, q, std, logit)] — q negated to the parent's view."""
    out = []
    for item in line.strip().split(","):
        if not item:
            continue
        move, visits, ev, std, logit = item.split(":")
        out.append((move, int(visits), -to_value(ev), float(std), float(logit)))
    return out


def load(path):
    with open(path, "r", encoding="utf-8") as f:
        return [parse_line(line) for line in f if line.strip()]


SIGMA_VARIANTS = {
    "sigma1_(50+N)": lambda q, n: q * (50 + n),
    "sigma2_N": lambda q, n: q * n,
    "sigma3_sqrtN": lambda q, n: q * math.sqrt(n),
    "sigma4_halfsqrtN": lambda q, n: q * math.sqrt(n) * 0.5,
}


def analyze(roots, beta: float = 0.5) -> dict:
    picked_is_best = 0
    picked_values, best_values = [], []
    variant_agree = {k: 0 for k in SIGMA_VARIANTS}
    counted = 0
    for xs in roots:
        visited = [x for x in xs if x[1] > 0]
        if not visited:
            continue
        counted += 1
        picked = max(visited, key=lambda x: x[1])
        best = max(visited, key=lambda x: x[2] + beta * x[3])
        picked_is_best += picked[0] == best[0]
        picked_values.append(picked[2])
        best_values.append(best[2] + beta * best[3])
        total_visits = sum(x[1] for x in visited)
        # Improved-policy argmax per sigma variant vs the actual pick.
        for name, fn in SIGMA_VARIANTS.items():
            imp = max(
                visited,
                key=lambda x: x[4] + fn(x[2] + beta * x[3], total_visits),
            )
            variant_agree[name] += imp[0] == picked[0]
    if not counted:
        return {"roots": 0}
    return {
        "roots": counted,
        "picked_is_best_rate": picked_is_best / counted,
        "mean_picked_value": float(np.mean(picked_values)),
        "mean_best_value_plus_uncertainty": float(np.mean(best_values)),
        **{
            f"agree_{k}": v / counted for k, v in variant_agree.items()
        },
    }


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dumps", nargs="+")
    parser.add_argument("--beta", type=float, default=0.5)
    args = parser.parse_args(argv)
    for path in args.dumps:
        stats = analyze(load(path), beta=args.beta)
        print(path)
        for k, v in stats.items():
            print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")


if __name__ == "__main__":
    main()
