"""Where the time of one selfplay move goes, on the card.

    python -m takzero_torch.profile_move [--budget 96] [--sampled 8] [--out build/profile_move.txt]

(``--device cpu`` runs it on the CPU at whatever small sizes the
``TAKZERO_BENCH_*`` overrides give, to rehearse the script.)

Sets up the flagship configuration of ``takzero_torch.bench`` with a
smaller search (k=8, budget 96 by default: the profiler's cost per event
makes one full 768-simulation move take over twelve minutes to record and
sum, while each simulation does the same work at any budget), plays one
warm-up move, then one move under
``torch.profiler`` with CPU and CUDA activities.  Prints one JSON line:
the move's wall seconds under the profiler, the summed time of its device
events (kernels and copies), the device's idle share (1 - device time /
wall time), the number of device events and of host syncs (``aten::item``
and ``aten::is_nonzero`` calls), the device time of the network's
convolutions (every kernel under ``aten::convolution``, layout transposes
included), the move's simulations by how their phases ran (eager, captured
into CUDA graphs or replayed: ``search/graphs.py`` ``MIDDLES``), per
simulation (``budget + 1`` a move): the device events, the CUDA graph
launches, the host syncs inside the search's ``search.*`` spans and the
launches of the descent and backup kernels (the launch counters,
``ops/_build.py``), and the
operators that take the most host time and the kernels that take the most
device time.  The full operator table goes to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bench import BenchConfig, setup
from .ops import _build
from .search import graphs

SYNC_OPS = ("aten::item", "aten::is_nonzero")
SEARCH_SPANS = ("search.forward", "search.evaluate", "search.apply_eval", "search.backward")


def _top(rows, key, n: int = 12) -> list:
    rows = sorted(rows, key=key, reverse=True)[:n]
    return [
        {"op": r.key, "calls": r.count, "host_ms": r.self_cpu_time_total / 1e3,
         "device_ms": _device_us(r) / 1e3}
        for r in rows
    ]


def _device_us(row) -> float:
    return getattr(row, "self_device_time_total", getattr(row, "self_cuda_time_total", 0.0))


def _device_total_us(row) -> float:
    return getattr(row, "device_time_total", getattr(row, "cuda_time_total", 0.0))


def _inside_search(events) -> int:
    """Host syncs (``SYNC_OPS``) that lie inside a ``search.*`` span of
    their own thread."""
    spans: dict = {}
    for e in events:
        if e.name in SEARCH_SPANS and e.device_type == DeviceType.CPU:
            spans.setdefault(e.thread, []).append((e.time_range.start, e.time_range.end))
    return sum(1 for e in events if e.name in SYNC_OPS and e.device_type == DeviceType.CPU
               and any(s <= e.time_range.start and e.time_range.end <= t for s, t in spans.get(e.thread, ())))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget", type=int, default=96)
    ap.add_argument("--sampled", type=int, default=8)
    ap.add_argument("--out", default="build/profile_move.txt")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    cfg = dataclasses.replace(
        BenchConfig.from_env(), budget=args.budget, sampled=args.sampled, moves=1
    )
    st = setup(cfg, args.device)
    on_card = st.sp.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    st.move()  # warm-up
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    middles = dict(graphs.MIDDLES)
    walks = _build.launch_counts()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        st.move()
        sync()
        wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    rows = prof.key_averages()
    # A span (``utils/profile.py``) also shows as a device range over the
    # kernels it launched: count kernels and copies only.
    events = prof.events()
    on_device = [e for e in events
                 if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    syncs = sum(r.count for r in rows if r.key in SYNC_OPS)
    sims = args.budget + 1
    graph_launches = sum(1 for e in events if e.name.startswith("cudaGraphLaunch"))
    conv_us = sum(_device_total_us(r) for r in rows if r.key == "aten::convolution")
    host_rows = [r for r in rows if r.device_type == DeviceType.CPU]
    device_rows = [r for r in rows
                   if r.device_type == DeviceType.CUDA and not getattr(r, "is_user_annotation", False)]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(rows.table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "budget": args.budget,
        "sampled": args.sampled,
        "wall_s_under_profiler": wall,
        "device_busy_s": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "device_events": len(on_device),
        "host_syncs": syncs,
        "conv_device_ms": conv_us / 1e3,
        "middles": {k: graphs.MIDDLES[k] - middles[k] for k in middles},
        "per_simulation": {
            "device_events": len(on_device) / sims,
            "graph_launches": graph_launches / sims,
            "host_syncs_in_search": _inside_search(events) / sims,
            "tree_kernel_launches": {walk: (launches[f"tree_{walk}"] - walks[f"tree_{walk}"]) / sims
                                     for walk in ("descend", "backup")},
        },
        "top_by_host": _top(host_rows, lambda r: r.self_cpu_time_total),
        "top_by_device": _top(device_rows, _device_us),
        "table": str(out),
    }))


if __name__ == "__main__":
    main()
