"""Forms of the path visit-count update, timed against the pool size M.

Counterpart of ``takzero_tpu/tools/scatter_variants.py``.  One
simulation adds a visit to each (node, slot) edge of every lane's path:
[B, D] element adds into the [B, M, C] visit pool (int32, or ``--dtype``
float32 or bfloat16, as JAX's ``--dtype``).  The port's own
form (``search/core.py`` ``add_path_visits``: ``index_put_`` with
``accumulate=True``, padding routed to the scratch row) is timed beside:

* ``index_put clip(0)``: JAX's baseline, padding clipped to row 0 with a
  zero update;
* ``scatter_add_``: the same adds through a flat [B, M*C] view;
* ``onehot row``: a row-level ``index_put_`` of one-hot [B, D, C] rows;
* ``onehot einsum``: a dense contraction of one-hot [B, D, M] and
  [B, D, C] (no scatter at all).

Paths are JAX's: distinct rows a lane, a third or more padded with -1.
Each line gives microseconds an update (CUDA events after one warm-up
pass, the path rolled each iteration) and the profiler's device kernels
and device time an update; every variant must give the core form's array
exactly, and the tool raises if one does not.

    python -m takzero_torch.tools.scatter_variants [--pools 776,1552,3104] [--iters 64]
        [--dtype int32|float32|bfloat16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..search.core import add_path_visits
from . import cliff_timing as ct


def paths(b: int, m: int, c: int, d: int, dev: torch.device, seed: int = 0):
    """(path_node, path_slot) int32[B, D]: distinct live rows a lane, -1 padding."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    node = torch.stack([torch.randperm(m - 1, generator=gen, device=dev)[:d] for _ in range(b)])
    length = torch.randint(d // 3, d, (b, 1), generator=gen, device=dev)
    live = torch.arange(d, device=dev)[None, :] < length
    slot = torch.randint(0, c, (b, d), generator=gen, device=dev)
    return (torch.where(live, node, -1).to(torch.int32), torch.where(live, slot, -1).to(torch.int32))


def variants(m: int, c: int) -> dict:
    """name -> update(visit [B, M, C] of the pool's dtype, path_node, path_slot), in place."""

    def clip0(a, node, slot):
        bar = torch.arange(a.shape[0], device=a.device)[:, None].expand_as(node)
        a.index_put_((bar, node.clamp(min=0).long(), slot.clamp(min=0).long()), (node >= 0).to(a.dtype),
                     accumulate=True)

    def scatter_add(a, node, slot):
        live = node >= 0
        lin = torch.where(live, node, m - 1).long() * c + slot.clamp(min=0).long()
        a.view(a.shape[0], m * c).scatter_add_(1, lin, live.to(a.dtype))

    def onehot_row(a, node, slot):
        bar = torch.arange(a.shape[0], device=a.device)[:, None].expand_as(node)
        oh = (slot[:, :, None] == torch.arange(c, device=a.device)).to(a.dtype)
        a.index_put_((bar, torch.where(node >= 0, node, m - 1).long()), oh, accumulate=True)

    def onehot_einsum(a, node, slot):
        ohm = (node[:, :, None] == torch.arange(m, device=a.device)).float()
        ohc = (slot[:, :, None] == torch.arange(c, device=a.device)).float()
        a += torch.einsum("bdm,bdc->bmc", ohm, ohc).to(a.dtype)

    return {"core.py index_put": add_path_visits, "index_put clip(0)": clip0, "scatter_add_": scatter_add,
            "onehot row": onehot_row, "onehot einsum": onehot_einsum}


DTYPES = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def check_variants(b: int, m: int, c: int, d: int, dev: torch.device, dtype=torch.int32) -> None:
    """Every variant's array equals the core form's after one update."""
    node, slot = paths(b, m, c, d, dev)
    out = {}
    for name, fn in variants(m, c).items():
        a = torch.zeros((b, m, c), dtype=dtype, device=dev)
        fn(a, node, slot)
        out[name] = a
    want = out["core.py index_put"]
    assert int(want.sum()) == int((node >= 0).sum()) > 0
    for name, a in out.items():
        if not torch.equal(a, want):
            raise AssertionError(f"scatter_variants: {name} differs from search/core.py's update at M={m}")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pools", default="776,1552,3104")
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--children", type=int, default=256)
    p.add_argument("--depth", type=int, default=48)
    p.add_argument("--dtype", default="int32", choices=DTYPES, help="the pool's dtype (default int32)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    dev, card = ct.device_and_card(args.device)
    b, c, d = args.batch, args.children, args.depth
    dtype = DTYPES[args.dtype]
    rows = []
    for m in ct.pools(args.pools):
        check_variants(b, m, c, d, dev, dtype)
        node, slot = paths(b, m, c, d, dev)
        for name, fn in variants(m, c).items():
            a = torch.zeros((b, m, c), dtype=dtype, device=dev)
            rolled = [(node.roll(i, 1), slot.roll(i, 1)) for i in range(args.iters)]

            def loop(fn=fn, a=a, rolled=rolled):
                for pn, ps in rolled:
                    fn(a, pn, ps)

            us = ct.ms_per_call(loop, dev) * 1e3 / args.iters
            prof = ct.kernel_profile(loop, dev)
            row = {"M": m, "variant": name, "us_per_iter": us, **{k: v / args.iters for k, v in prof.items()},
                   "equal_to_core": True, "dtype": args.dtype, "device": str(dev), "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
