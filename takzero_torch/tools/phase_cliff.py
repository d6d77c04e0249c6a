"""Which phase of a simulation grows with the pool size M.

Counterpart of ``takzero_tpu/tools/phase_cliff.py``: with the stub
evaluator, times (a) ``forward`` alone, (b) ``forward`` and
``apply_eval`` and (c) the full ``simulate`` (``search/core.py``'s
``simulate.phases``) at a sweep of pool sizes, in milliseconds a
simulation (CUDA events after a warm-up on a fresh tree, built outside
the timed region), each with the profiler's device kernels and device
time a simulation (over the first ``cliff_timing.PROFILE_SIMS``
simulations of a fresh tree).

    python -m takzero_torch.tools.phase_cliff [--pools 776,3104] [--sims 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from . import cliff_timing as ct


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pools", default="776,3104")
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--children", type=int, default=256)
    p.add_argument("--max-depth", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from ..search.core import make_kernels
    from ..search.tree import init_tree
    from ..tak.engine import engine

    dev, card = ct.device_and_card(args.device)
    eng = engine(6, half_komi=4)
    evaluator = ct.stub_evaluator(eng)
    simulate, _ = make_kernels(eng, evaluator, max_depth=args.max_depth)
    fwd, app = simulate.phases["forward"], simulate.phases["apply_eval"]
    envs = ct.openings(eng, args.batch, args.seed, dev)
    beta = torch.full((args.batch,), 0.25, device=dev)

    def forward(tree):
        fwd(tree, beta, None, False)

    def forward_apply(tree):
        rec = fwd(tree, beta, None, False)
        app(tree, rec, *evaluator(rec["env_eval"]))

    def full(tree):
        simulate(tree, beta)

    profiled = min(args.sims, ct.PROFILE_SIMS)
    rows = []
    for m in ct.pools(args.pools):
        for name, step in (("forward", forward), ("fwd+apply", forward_apply), ("full", full)):

            def sims(tree, count=args.sims, step=step):
                for _ in range(count):
                    step(tree)

            def timed(count: int = 0, sims=sims):
                """ms of ``--sims`` simulations, or the profile of ``count``."""
                tree = init_tree(eng, envs, m, args.children)
                if count:
                    return ct.kernel_profile(lambda: sims(tree, count), dev)
                return ct.ms_per_call(lambda: sims(tree), dev, warmup=0)

            timed()  # warm-up
            row = {"M": m, "phase": name, "ms_per_sim": timed() / args.sims,
                   **{k: v / profiled for k, v in timed(profiled).items()},
                   "sims": args.sims, "batch": args.batch, "device": str(dev), "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
