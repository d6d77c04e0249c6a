"""Trace what a simulation does over the whole pool, at two pool sizes.

Counterpart of ``takzero_tpu/tools/slope_trace.py``, which compiles one
fused simulation loop at two pool sizes and diffs XLA's instructions by
opcode and output shape (and the compiler's cost analysis).  The port has
no compiled module: it runs ``--sims`` simulations (stub evaluator) under
``torch.profiler`` at each pool size and diffs the counts of each
operator by input shape and of each device kernel by name.  The
operators whose input shapes carry M (the pools' M + 1 rows) are the work done over the whole
pool rather than a touched row; the device kernels and their device time
a simulation stand in for the cost analysis.  Writes ``report.txt`` (one
line per operator and shape that carries M: name, shapes at the larger
M, count there, count at the smaller) into ``--out``.

    python -m takzero_torch.tools.slope_trace [--pools 776,3104] [--sims 16]
        [--out build/slope_trace] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re

import torch

from . import cliff_timing as ct


def carries(shapes: str, m: int) -> bool:
    """Whether a recorded input-shape list has a dimension of size ``m``."""
    return re.search(rf"\b{m}\b", shapes) is not None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pools", default="776,3104")
    p.add_argument("--sims", type=int, default=16)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--children", type=int, default=256)
    p.add_argument("--max-depth", type=int, default=48)
    p.add_argument("--out", default="build/slope_trace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    lo, hi = ct.pools(args.pools)

    from ..search.core import make_simulate
    from ..search.tree import init_tree
    from ..tak.engine import engine

    dev, card = ct.device_and_card(args.device)
    eng = engine(6, half_komi=4)
    simulate = make_simulate(eng, ct.stub_evaluator(eng), max_depth=args.max_depth)
    envs = ct.openings(eng, args.batch, args.seed, dev)
    beta = torch.full((args.batch,), 0.25, device=dev)
    profiles = {}
    for m in (lo, hi):

        def sims(tree):
            for _ in range(args.sims):
                simulate(tree, beta)

        sims(init_tree(eng, envs, m, args.children))  # warm-up
        tree = init_tree(eng, envs, m, args.children)
        profiles[m] = ct.kernel_profile(lambda: sims(tree), dev, shapes=True)
        summary = {k: v / args.sims for k, v in profiles[m].items() if k != "histogram"}
        print(json.dumps({"M": m, "per_sim": summary, "distinct": len(profiles[m]["histogram"]),
                          "device": str(dev), "card": card}), flush=True)

    lo_h, hi_h = profiles[lo]["histogram"], profiles[hi]["histogram"]
    rows = []
    for (kind, name, shapes), n in hi_h.items():
        # The pools hold M + 1 rows (the scratch row, search/tree.py).
        if kind == "op" and carries(shapes, hi + 1):
            rows.append((name, shapes, n, lo_h.get((kind, name, re.sub(rf"\b{hi + 1}\b", str(lo + 1), shapes)), 0)))
    rows.sort(key=lambda r: -r[2])
    kernels = sorted(((name, hi_h[k], lo_h.get(k, 0)) for k in hi_h if (name := k[1]) and k[0] == "kernel"),
                     key=lambda r: -r[1])
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "report.txt", "w") as f:
        f.write(f"pools {lo} vs {hi}; sims={args.sims}; card={card}\n")
        for name, shapes, n_hi, n_lo in rows:
            f.write(f"{name}\t{shapes}\t{n_hi}\t{n_lo}\n")
    result = {"pools": [lo, hi], "sims": args.sims, "card": card,
              "per_sim": {m: {k: v / args.sims for k, v in prof.items() if k != "histogram"}
                          for m, prof in profiles.items()},
              "ops_over_the_pool": [{"op": n, "shapes": s, "count_hi": a, "count_lo": b} for n, s, a, b in rows[:20]],
              "kernels_changed": [{"kernel": n, "count_hi": a, "count_lo": b} for n, a, b in kernels if a != b][:20],
              "report": str(out_dir / "report.txt")}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
