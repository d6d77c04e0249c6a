"""Which tree-op primitive's cost grows with the pool size M.

Counterpart of ``takzero_tpu/tools/op_cliff.py``: times ``--iters``
applications of single primitives over [B, M, C] pool arrays at a sweep
of M: a row gather, a row scatter, the path's element scatter-add
([B, D] (row, slot) adds, the visit update), the same through a flat
[B, M*C] view, a one-hot row scatter-add, a [B]-indexed element store, a
chained gather and scatter on one array, and 8 row scatters.  Each line
gives microseconds an application (CUDA events after one warm-up pass)
and, where JAX's tool leaves XLA's lowering to the reader, the profiler's
device kernels and device time an application.

    python -m takzero_torch.tools.op_cliff [--pools 776,1552,3104] [--iters 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from . import cliff_timing as ct


def primitives(b: int, m: int, c: int, d: int, dev: torch.device, seed: int = 0) -> dict:
    """name -> (body(i), the array it writes): one application each."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    arr = torch.randn((b, m, c), generator=gen, device=dev)
    idx = torch.randint(0, m, (b,), generator=gen, device=dev)
    row = torch.randn((b, c), generator=gen, device=dev)
    pidx = torch.randint(0, m, (b, d), generator=gen, device=dev)
    sidx = torch.randint(0, c, (b, d), generator=gen, device=dev)
    bar = torch.arange(b, device=dev)
    bard = bar[:, None].expand(b, d)
    onehot = (sidx[:, :, None] == torch.arange(c, device=dev)).float()
    acc = torch.zeros((), device=dev)

    def gather(i):
        acc.add_(arr[bar, (idx + i) % m].sum())

    def scatter(i):
        arr[bar, (idx + i) % m] = row + i

    def path_add(i):
        arr.index_put_((bard, (pidx + i) % m, sidx), torch.ones((), device=dev), accumulate=True)

    def flat_path_add(i):
        arr.view(b, m * c).index_put_((bard, ((pidx + i) % m) * c + sidx), torch.ones((), device=dev),
                                      accumulate=True)

    def onehot_row_add(i):
        arr.index_put_((bard, (pidx + i) % m), onehot, accumulate=True)

    def elem_store(i):
        arr[bar, (idx + i) % m, sidx[:, 0]] = 1.0 + i

    def gather_scatter(i):
        arr[bar, (idx + i + 1) % m] = arr[bar, (idx + i) % m] + 1.0

    def scatter8(i):
        for j in range(8):
            arr[bar, (idx + i + j) % m] = row + i + j

    return {"row gather [B,C]": gather, "row scatter set": scatter, "path scatter-add [B,D]": path_add,
            "flat path scatter-add": flat_path_add, "onehot row scatter-add": onehot_row_add,
            "elem scatter [B]": elem_store, "gather+scatter chain": gather_scatter, "8x row scatter": scatter8}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pools", default="776,1552,3104")
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--children", type=int, default=256)
    p.add_argument("--depth", type=int, default=48)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    dev, card = ct.device_and_card(args.device)
    rows = []
    for m in ct.pools(args.pools):
        for name, body in primitives(args.batch, m, args.children, args.depth, dev).items():

            def loop(body=body):
                for i in range(args.iters):
                    body(i)

            us = ct.ms_per_call(loop, dev) * 1e3 / args.iters
            prof = ct.kernel_profile(loop, dev)
            row = {"M": m, "op": name, "us_per_iter": us, **{k: v / args.iters for k, v in prof.items()},
                   "device": str(dev), "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
