"""Replay-buffer set analysis -> opening books
(reference visualize_replay_buffer/src/main.rs:150-201).

Counterpart of ``takzero_tpu/drivers/visualize_replay_buffer.py``: samples
positions from two replay files, computes the intersection and the two
differences, and writes a secondary sample of each as opening books (one
TPS per line), byte for byte as JAX's for the same ``--seed``.  The
replays are replayed on the port's engine on ``--device`` (default
``cuda``, which raises without CUDA; ``--device cpu`` runs on the CPU);
only the positions come back to the host for their TPS.

Usage:
    python -m takzero_torch.drivers.visualize_replay_buffer \
        --n 4 a_replays.txt b_replays.txt [--initial 1000000] [--sample 2000] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np


def sample_positions(n: int, path, limit: int, device=None) -> set[str]:
    """First `limit` positions of the replay stream, as TPS strings; the
    replays are stepped on ``device`` (default ``cuda``; raises without
    CUDA)."""
    from ..data.native_loader import replay_line_tps
    from ..device import resolve_device
    from ..tak.engine import engine

    out: set[str] = set()
    count = 0
    for tps in replay_line_tps(engine(n), path, resolve_device(device)):
        for key in tps:
            out.add(key)
            count += 1
            if count >= limit:
                return out
    return out


def save_book(path, positions, sample: int, rng: np.random.Generator) -> int:
    positions = sorted(positions)
    if len(positions) > sample:
        idx = rng.choice(len(positions), sample, replace=False)
        positions = [positions[i] for i in idx]
    pathlib.Path(path).write_text("\n".join(positions) + "\n", encoding="utf-8")
    return len(positions)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("replays_a")
    parser.add_argument("replays_b")
    parser.add_argument("--n", type=int, default=4)
    parser.add_argument("--initial", type=int, default=1_000_000)
    parser.add_argument("--sample", type=int, default=2_000)
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--out-prefix", default="positions")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    a = sample_positions(args.n, args.replays_a, args.initial, args.device)
    b = sample_positions(args.n, args.replays_b, args.initial, args.device)
    name_a = pathlib.Path(args.replays_a).stem.replace("_replays", "")
    name_b = pathlib.Path(args.replays_b).stem.replace("_replays", "")
    books = {}
    for label, positions in (
        ("both", a & b),
        (f"only_{name_a}", a - b),
        (f"only_{name_b}", b - a),
    ):
        path = f"{args.out_prefix}_{label}.opening_book"
        count = save_book(path, positions, args.sample, rng)
        books[path] = count
        print(f"{path}: {count} positions (from {label} = "
              f"{len(positions)})")
    return books


if __name__ == "__main__":
    main()
