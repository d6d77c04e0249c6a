"""Opening-book generation (reference python/generate_openings.py).

Counterpart of ``takzero_tpu/tools/openings.py``: enumerates all
flat-placement-only openings to a given depth on the port's oracle, dedupes
by canonical form (minimum TPS over the 8 board symmetries), and prints one
TPS per line — the opening-book format the evaluation driver reads.
Host-only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tak.oracle import Oracle, initial_state
from ..tak.symmetry import transform_state
from ..tak.tps import state_to_tps


def canonical_tps(n: int, state) -> str:
    """Minimum TPS over the 8 symmetries of one host position."""
    batch = state.map(lambda x: x.unsqueeze(0).expand(8, *x.shape))
    moved = transform_state(n, batch, torch.arange(8))
    return min(state_to_tps(n, moved.map(lambda x, t=t: x[t])) for t in range(8))


def generate_openings(n: int, half_komi: int, depth: int) -> list[str]:
    orc = Oracle(n, half_komi)
    seen: dict[str, object] = {}

    def expand(state, d):
        if d <= 0:
            seen.setdefault(canonical_tps(n, state), state)
            return
        legal = np.nonzero(orc.legal_mask(state))[0]
        # Flat placements only: action index == square for channel 0.
        for a in legal[legal < n * n]:
            expand(orc.step(state, int(a)), d - 1)

    expand(initial_state(n), depth)
    return sorted(seen)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--size", type=int, default=4)
    parser.add_argument("--half-komi", type=int, default=4)
    parser.add_argument("--depth", type=int, default=3)
    parser.add_argument("--out", help="write to file instead of stdout")
    args = parser.parse_args(argv)
    lines = generate_openings(args.size, args.half_komi, args.depth)
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"{len(lines)} openings -> {args.out}")
    else:
        print(text, end="")


if __name__ == "__main__":
    main()
