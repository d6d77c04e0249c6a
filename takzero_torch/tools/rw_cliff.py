"""Does gathering from and scattering to one pool array in one step make
the step's cost grow with the pool size M?

Counterpart of ``takzero_tpu/tools/rw_cliff.py``.  In JAX the question is
whether XLA copies a loop-carried [B, M, C] array that is both read and
row-written in one iteration.  PyTorch writes in place, so the port's
answer is expected flat; the tool keeps JAX's three bodies to show it:

* ``scatter``: a row scatter only (the control);
* ``gather``: a row gather, written into row 0 (the control);
* ``gather+sc``: a row gathered and written back to the next row.

Each line gives microseconds an iteration (CUDA events after one warm-up
pass) and the profiler's device kernels and device time an iteration;
the last line, each body's times from the smallest to the largest M.

    python -m takzero_torch.tools.rw_cliff [--pools 776,1544,3104] [--iters 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from . import cliff_timing as ct


def bodies(b: int, m: int, c: int, dev: torch.device) -> dict:
    arr = torch.zeros((b, m, c), device=dev)
    lanes = torch.arange(b, device=dev)

    def scatter(i):
        arr[lanes, (i * 7 + lanes) % m] = torch.full((b, c), float(i), device=dev)

    def gather(i):
        g = arr[lanes, (i * 7 + lanes) % m]
        arr[lanes, 0] = torch.maximum(arr[lanes, 0], g * 0 + i)  # touches row 0 only

    def rw(i):
        rows = (i * 7 + lanes) % m
        arr[lanes, (rows + 1) % m] = arr[lanes, rows] + 1

    return {"scatter": scatter, "gather": gather, "gather+sc": rw}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pools", default="776,1544,3104")
    p.add_argument("--iters", type=int, default=128)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--children", type=int, default=256)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    dev, card = ct.device_and_card(args.device)
    rows = []
    for m in ct.pools(args.pools):
        for name, body in bodies(args.batch, m, args.children, dev).items():

            def loop(body=body):
                for i in range(args.iters):
                    body(i)

            us = ct.ms_per_call(loop, dev) * 1e3 / args.iters
            prof = ct.kernel_profile(loop, dev)
            row = {"M": m, "body": name, "us_per_iter": us, **{k: v / args.iters for k, v in prof.items()},
                   "device": str(dev), "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    slope = {name: [r["us_per_iter"] for r in rows if r["body"] == name] for name in ("scatter", "gather", "gather+sc")}
    print(json.dumps({"us_per_iter_by_M": slope, "pools": ct.pools(args.pools), "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
