"""Baseline anchor: measure the two halves of the reference's selfplay stack
with the engines this machine can run.

Counterpart of ``takzero_tpu/tools/anchor.py``.  The reference (Rust +
tch/LibTorch, CUDA) is not built here, so its selfplay rate is composed
from two measured halves:

1. **Search machinery** (pointer tree + rules engine, no NN): the port's
   build of ``cpp/tak_mcts_bench`` — a C++ re-creation of the reference's
   sequential PUCT architecture (see its header for the file:line map) at
   the reference selfplay config (6x6, budget 768), one host core.
2. **NN inference**: the reference evaluates one batch-128 forward of its
   16x256 ResNet per simulation step across 128 parallel games
   (takzero/src/network/net6.rs; batched.rs:243-268).  Here the same-shape
   float32 torch network runs on ``--device`` (default ``cuda``), the
   backend the reference's LibTorch would use on a machine with a card.

Composed estimate per actor process (both stages are serial in the
reference's loop):   sims/s = 1 / (1/search + 1/nn_positions)
scaled by min(20 actor processes, host cores) (README.md:128-135 of the
reference), which ignores contention, i.e. stays generous to the reference.

The JSON keeps JAX's keys, except that the network's rate is named for the
device it ran on (``host_nn_positions_per_s_torch_cuda`` on the card).
``--write`` records the numbers under ``"published"`` in the JSON file
``--baseline`` names (default ``build/baseline_h100.json`` in the
repository, git-ignored).  JAX's ``--write`` updates the repository's
``BASELINE.json``, but that file is the JAX package's record of a CPU
anchor, which the port leaves as it is.

Usage: python -m takzero_torch.tools.anchor [--quick] [--device cuda]
    [--write] [--baseline PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _cpp_build

ACTOR_PROCESSES = 20  # 10 selfplay + 10 reanalyze, README.md:128-135
BASELINE = Path(__file__).resolve().parents[2] / "build" / "baseline_h100.json"


def measure_search(quick: bool) -> dict:
    exe = _cpp_build.build("tak_mcts_bench")
    out = subprocess.run([str(exe), "--moves", "4" if quick else "20"], check=True, capture_output=True,
                         text=True).stdout
    return json.loads(out)


def measure_nn(quick: bool, device) -> dict:
    from ..ops.repr import input_channels
    from ..tak.moves import action_space

    n, filters, blocks, batch = 6, 256, 16, 128
    in_ch, out_ch = input_channels(n), action_space(n).num_channels

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = torch.nn.Conv2d(filters, filters, 3, padding=1, bias=False)
            self.b1 = torch.nn.BatchNorm2d(filters)
            self.c2 = torch.nn.Conv2d(filters, filters, 3, padding=1, bias=False)
            self.b2 = torch.nn.BatchNorm2d(filters)

        def forward(self, x):
            y = torch.relu(self.b1(self.c1(x)))
            return torch.relu(x + self.b2(self.c2(y)))

    class Net(torch.nn.Module):
        """Same shape as models/network.py TakNet (reference net6.rs)."""

        def __init__(self):
            super().__init__()
            self.stem = torch.nn.Sequential(
                torch.nn.Conv2d(in_ch, filters, 3, padding=1, bias=False),
                torch.nn.BatchNorm2d(filters),
                torch.nn.ReLU(),
            )
            self.blocks = torch.nn.Sequential(*[Block() for _ in range(blocks)])
            self.policy = torch.nn.Conv2d(filters, out_ch, 3, padding=1)
            self.value1 = torch.nn.Conv2d(filters, 1, 1)
            self.value2 = torch.nn.Linear(n * n, 1)
            self.ube1 = torch.nn.Conv2d(filters, 1, 1)
            self.ube2 = torch.nn.Linear(n * n, 1)

        def forward(self, x):
            core = self.blocks(self.stem(x))
            pol = self.policy(core).flatten(1)
            val = torch.tanh(self.value2(torch.relu(self.value1(core)).flatten(1)))
            ube = self.ube2(torch.relu(self.ube1(core)).flatten(1))
            return pol, val[:, 0], ube[:, 0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    net = Net().eval().to(device)
    x = torch.randn(batch, in_ch, n, n, device=device)
    with torch.no_grad():
        net(x)  # warm
        sync()
        iters = 3 if quick else 10
        t0 = time.perf_counter()
        for _ in range(iters):
            net(x)
        sync()
        dt = (time.perf_counter() - t0) / iters
    return {"batch": batch, "forward_s": dt, "positions_per_s": batch / dt, "threads": torch.get_num_threads()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device of the network half (default cuda)")
    parser.add_argument("--write", action="store_true", help="record into --baseline's ['published']")
    parser.add_argument("--baseline", default=str(BASELINE),
                        help="JSON file --write updates (default build/baseline_h100.json; never BASELINE.json)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    search = measure_search(args.quick)
    nn = measure_nn(args.quick, dev)
    per_actor = 1.0 / (1.0 / search["sims_per_s"] + 1.0 / nn["positions_per_s"])
    effective = min(ACTOR_PROCESSES, os.cpu_count() or 1)
    anchor = {
        "host_search_sims_per_s_1core_no_nn": round(search["sims_per_s"], 1),
        f"host_nn_positions_per_s_torch_{dev.type}": round(nn["positions_per_s"], 1),
        "host_nn_threads": nn["threads"],
        "host_cores": os.cpu_count(),
        "reference_on_this_host_sims_per_s_per_actor": round(per_actor, 1),
        "actor_processes_deployed": ACTOR_PROCESSES,
        "actor_processes_effective": effective,
        "reference_on_this_host_sims_per_s_total": round(per_actor * effective, 1),
        "method": f"takzero_torch/tools/anchor.py: C++ reference-architecture MCTS (no NN) composed with "
                  f"torch-{dev.type} float32 16x256 ResNet batch-128 forwards; x min(20 actor processes per "
                  "README.md:128-135, host cores) — ignores core contention, i.e. generous to the reference",
    }
    print(json.dumps(anchor, indent=2))
    if args.write:
        path = Path(args.baseline)
        data = json.loads(path.read_text()) if path.exists() else {}
        data.setdefault("published", {}).update(anchor)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data, indent=2) + "\n")
    return anchor


if __name__ == "__main__":
    main()
