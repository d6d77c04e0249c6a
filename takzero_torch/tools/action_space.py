"""Closed-form Tak action-space counts (reference python/action_space.py).

Validates the closed-form formulas against the framework's exact
enumeration (tak/moves.py) — the same counts the reference hardcodes in
repr.rs:16-34.

The port's copy of ``takzero_tpu/tools/action_space.py`` (host code only).
"""

from __future__ import annotations

from functools import lru_cache


def placements(n: int) -> int:
    # flats + walls everywhere; capstones only for n >= 5
    return (2 if n < 5 else 3) * n * n


@lru_cache(maxsize=None)
def _spread_exactly_into_exactly(n: int, k: int) -> int:
    if n < k:
        return 0
    if k == n or k == 1:
        return 1
    return sum(_spread_exactly_into_exactly(n - i, k - 1) for i in range(1, n - k + 2))


def _spread_exactly_into(n: int, k: int) -> int:
    return sum(_spread_exactly_into_exactly(n, i) for i in range(1, k + 1))


@lru_cache(maxsize=None)
def _spread_up_to_into(n: int, k: int) -> int:
    return sum(_spread_exactly_into(i, k) for i in range(1, n + 1))


def spreads(n: int) -> int:
    """Total spread moves: carry 1..n stones into the run length available
    in each direction from each square."""
    return sum(
        _spread_up_to_into(n, x)
        + _spread_up_to_into(n, y)
        + _spread_up_to_into(n, n - x - 1)
        + _spread_up_to_into(n, n - y - 1)
        for x in range(n)
        for y in range(n)
    )


def total(n: int) -> int:
    return placements(n) + spreads(n)


def main(argv=None) -> None:
    import argparse

    from ..tak.moves import action_space

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--max-n", type=int, default=8)
    args = parser.parse_args(argv)
    print(
        f"{'n':>2} {'placements':>11} {'spreads':>9} {'real_moves':>10} "
        f"{'policy_size':>11}"
    )
    for n in range(3, args.max_n + 1):
        # policy_size = dense policy tensor (channels * n^2, repr.rs:103-116)
        dense = action_space(n).num_actions if n <= 6 else "-"
        print(
            f"{n:>2} {placements(n):>11} {spreads(n):>9} {total(n):>10} {dense:>11}"
        )


if __name__ == "__main__":
    main()
