"""The search's cost against the tree pool's size M.

Counterpart of ``takzero_tpu/tools/pool_cliff.py``.  Every op of a
simulation reads or writes rows of the [B, M, C] pool, so its cost should
not grow with M; JAX measured ~24% a pool doubling at C=256.  This times
the port's ``simulate`` (``search/core.py``, the kernel the drivers run)
at a sweep of pool sizes, on the flagship 16x256 SimHash net or, with
``--stub``, a uniform evaluator (the tree's ops alone).  Each M gives
milliseconds a simulation (CUDA events over ``--sims`` simulations after
a warm-up of as many on a fresh tree, the best of ``--reps``; the
fresh tree is built outside the timed region) and, where JAX prints
``cost_analysis()``, the profiler's count of device kernels and their
device time a simulation (over the first ``cliff_timing.PROFILE_SIMS``
simulations of a fresh tree).  The port has no HLO: under JAX's
``--dump-hlo DIR`` it writes, for each M, that profiled pass's table to
``DIR/pool_cliff_M{M}.txt``: one line per device kernel by name (on the
CPU: per operator) and per operator by input shapes, with its count, the
same rows that ``slope_trace`` diffs between two pool sizes.

    python -m takzero_torch.tools.pool_cliff [--pools 776,1552,3104]
        [--sims 128] [--batch 128] [--children 256] [--stub] [--reps 3]
        [--dump-hlo DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from . import cliff_timing as ct


def dump_table(path: Path, hist, sims: int) -> None:
    """The profiled pass's (kind, name, input shapes) counts, most frequent
    first: ``count<TAB>kind<TAB>name<TAB>shapes``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [f"# {sims} simulations; count, kind, name, input shapes"]
    lines += [f"{n}\t{kind}\t{name}\t{shapes}" for (kind, name, shapes), n in
              sorted(hist.items(), key=lambda kv: (-kv[1], kv[0]))]
    path.write_text("\n".join(lines) + "\n")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pools", default="776,1552,3104")
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--children", type=int, default=256)
    p.add_argument("--max-depth", type=int, default=48)
    p.add_argument("--stub", action="store_true", help="uniform evaluator")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--dump-hlo", default=None, metavar="DIR",
                   help="write each M's profiled kernel and operator counts to DIR/pool_cliff_M{M}.txt "
                        "(the port has no HLO)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from ..models.agent import make_net_evaluate, new_agent
    from ..models.network import NetConfig
    from ..search.core import make_simulate
    from ..search.tree import init_tree
    from ..tak.engine import engine

    dev, card = ct.device_and_card(args.device)
    eng = engine(6, half_komi=4)
    if args.stub:
        evaluator = ct.stub_evaluator(eng)
    else:
        cfg = NetConfig(n=6, half_komi=4, filters=256, blocks=16, novelty="simhash", hash_bits=26)
        bundle, net_eval = new_agent(cfg, seed=args.seed, device=dev), make_net_evaluate(cfg, eng, device=dev)
        evaluator = lambda e: net_eval(bundle, e)  # noqa: E731
    simulate = make_simulate(eng, evaluator, max_depth=args.max_depth)
    envs = ct.openings(eng, args.batch, args.seed, dev)
    beta = torch.full((args.batch,), 0.25, device=dev)

    rows = []
    for m in ct.pools(args.pools):

        def sims(tree, count=args.sims):
            for _ in range(count):
                tree = simulate(tree, beta)

        def timed(count: int = 0):
            """ms of ``--sims`` simulations, or the profile of ``count``."""
            tree = init_tree(eng, envs, m, args.children)  # outside the timed region
            if count:
                return ct.kernel_profile(lambda: sims(tree, count), dev, shapes=bool(args.dump_hlo))
            return ct.ms_per_call(lambda: sims(tree), dev, warmup=0)

        timed()  # warm-up
        ms = min(timed() for _ in range(args.reps)) / args.sims
        profiled = min(args.sims, ct.PROFILE_SIMS)
        prof = timed(profiled)
        if args.dump_hlo:
            dump_table(Path(args.dump_hlo) / f"pool_cliff_M{m}.txt", prof.pop("histogram"), profiled)
        row = {"M": m, "ms_per_sim": ms, "sims_per_s": args.batch * 1e3 / ms,
               **{k: v / profiled for k, v in prof.items()}, "sims": args.sims, "batch": args.batch,
               "evaluator": "stub" if args.stub else "16x256 simhash", "device": str(dev), "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
