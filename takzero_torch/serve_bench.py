"""Serve nodes/s: TEI's chunk timed on one device.

Counterpart of ``takzero_tpu/tools/serve_bench.py``: the TEI driver's
``run_chunk`` (one plain simulation, then the wavefront serve chunk
collecting ``sim_chunk - 1`` leaves per network call) on net6_simhash with
random weights from seed 0, on a fresh tree of ``max_nodes`` rows and 128
child slots, the JAX tool's sizes.  One warm-up chunk, then ``chunks``
timed chunks on the host clock, synchronised at both ends.

Usage:  python -m takzero_torch.serve_bench [--chunks 8] [--sim-chunk 128]
            [--max-nodes 4096] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from .config import NET_PRESETS
from .device import resolve_device
from .drivers.tei import make_run_chunk
from .models.agent import new_agent
from .search.tree import init_tree
from .tak.engine import engine


def main(argv=None) -> dict:
    """Print and return ``nps``, ``seconds``, ``seconds_per_chunk``,
    ``chunks``, ``sim_chunk`` and ``device`` (the card's name)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--net", default="net6_simhash", choices=NET_PRESETS)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--sim-chunk", type=int, default=128)
    p.add_argument("--max-nodes", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = NET_PRESETS[args.net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    bundle = new_agent(cfg, seed=0, device=dev)
    run = make_run_chunk(cfg, eng, bundle, dev, args.sim_chunk)
    tree = init_tree(eng, eng.initial(1, dev), args.max_nodes, 128)
    tree = run(tree)  # warm-up
    tree.node_count.cpu()  # a host read waits for the device

    t0 = time.perf_counter()
    for _ in range(args.chunks):
        tree = run(tree)
    tree.node_count.cpu()
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    nps = args.sim_chunk * args.chunks / dt
    print(f"serve nps: {nps:.0f}  ({args.chunks} chunks x {args.sim_chunk} sims in {dt:.3f}s, "
          f"net={args.net}, device={name})", flush=True)
    return {"nps": nps, "seconds": dt, "seconds_per_chunk": dt / args.chunks, "chunks": args.chunks,
            "sim_chunk": args.sim_chunk, "device": name}


if __name__ == "__main__":
    main()
