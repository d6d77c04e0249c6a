"""Scaling check of the multihost learn path.

Counterpart of ``takzero_tpu/tools/multihost_scaling.py``.  Each
configuration ``PxD`` launches the real ``drivers/multihost.py`` ->
``drivers/learn.py`` chain as P launcher processes of D local ranks each
(a world of P * D ranks) on a pre-generated target file, with the GLOBAL
batch fixed, and reports the steps/s of the driver's own "chunk of N
flushed: X steps/s end-to-end" lines (the first chunk, short chunks and
the last chunk skipped; the median of the rest, then the median over
repeats).  The learner flushes its last chunk as it finishes, right
after the one before it with no batch assembled in between, so that
line's rate is not a steady-state rate.

Gross serialization faults in the multihost path (the coordinator's
broadcast reads degenerating to a collective per line) cost 10x and more,
and show even where the ranks share one host's cores or one card.  Real
1 -> N scaling needs N cards; ranks that share a card or the CPU measure
the cost of the collectives, not scaling.

    python -m takzero_torch.tools.multihost_scaling --out scaling.json
        [--configs 1x1,2x1,2x2] [--global-batch 32] [--steps 60]
        [--device cuda|cpu] [--backend nccl|gloo]

On cards each rank takes its own (``cuda:LOCAL_RANK``, NCCL); a
configuration that needs more cards than are visible raises, unless
``--backend gloo`` lets every rank share card 0.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile

_CHUNK_RE = re.compile(r"chunk of (\d+) flushed: ([\d.]+) steps/s")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_targets(directory: pathlib.Path, n_targets: int, seed: int, net: str, device) -> None:
    """Write a ``targets-selfplay.txt`` of random-game targets for the learner to tail."""
    import numpy as np

    from ..config import NET_PRESETS
    from ..tak.engine import engine
    from ..train.data import random_pretraining_targets

    cfg = NET_PRESETS[net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    targets = random_pretraining_targets(eng, n_targets, np.random.default_rng(seed), device=device)
    (directory / "targets-selfplay.txt").write_text("".join(t.to_line() + "\n" for t in targets))


def rank_device(procs: int, devs: int, device: str, backend: str | None) -> tuple[str, str]:
    """``(the driver's --device, the backend)`` of a configuration."""
    import torch

    if torch.device(device).type == "cpu":
        return "cpu", backend or "gloo"
    need = procs * devs
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "gloo" and visible < need:
        return "cuda:0", "gloo"  # every rank on card 0
    if visible < need:
        raise ValueError(f"{procs}x{devs} needs {need} cards, {visible} visible (--backend gloo shares one)")
    return "cuda", backend or "nccl"


def run_config(procs: int, devs: int, shared_targets: pathlib.Path, global_batch: int, steps: int,
               chunk_steps: int, timeout: float, net: str, device: str, backend: str | None) -> dict:
    """One (processes x ranks/process) run; returns its steps/s."""
    rank_dev, backend = rank_device(procs, devs, device, backend)
    run_dir = pathlib.Path(tempfile.mkdtemp(prefix=f"mhs_{procs}x{devs}_"))
    try:
        (run_dir / "targets-selfplay.txt").write_bytes(shared_targets.read_bytes())
        env = dict(os.environ)
        repo = str(pathlib.Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        if rank_dev == "cpu":  # the ranks share the host's cores
            env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // (procs * devs)))
        port = _free_port()
        driver_args = ["--directory", str(run_dir), "--net", net, "--batch-size", str(global_batch),
                       "--max-steps", str(steps), "--no-wait", "--pretrain-steps", "0",
                       "--chunk-steps", str(chunk_steps), "--device", rank_dev]
        # Children write to files, not pipes: a rank that fills a pipe's
        # buffer before rank 0 exits would block the collectives.
        logs = [open(run_dir / f"proc{pid}.out", "w+") for pid in range(procs)]
        ps = [
            subprocess.Popen(
                [sys.executable, "-m", "takzero_torch.drivers.multihost", "--coordinator", f"localhost:{port}",
                 "--num-processes", str(procs), "--process-id", str(pid), "--local-ranks", str(devs),
                 "--backend", backend, "learn", "--"] + driver_args,
                stdout=logs[pid], stderr=subprocess.STDOUT, env=env, text=True,
            )
            for pid in range(procs)
        ]
        try:
            for p in ps:
                p.wait(timeout=timeout)
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    for p, out in zip(ps, outs):
        if p.returncode:
            raise RuntimeError(f"{procs}x{devs} process failed:\n{out[-3000:]}")
    chunks, rate = steady_rate(outs[0], chunk_steps, f"{procs}x{devs}")
    return {
        "processes": procs,
        "devices_per_process": devs,
        "global_devices": procs * devs,
        "chunks": len(chunks),
        "steps_per_s": rate,
        "steps_per_s_all": [r for _, r in chunks],
        "device": rank_dev,
        "backend": backend,
    }


def steady_rate(log: str, chunk_steps: int, what: str = "run") -> tuple[list, float]:
    """``(every (steps, steps/s) chunk line of a learner's log, the median
    steady rate)``: the first chunk (warm-up), the last (flushed as the
    learner finishes), short boundary chunks and zero rates are dropped."""
    chunks = [(int(m.group(1)), float(m.group(2))) for m in _CHUNK_RE.finditer(log)]
    if len(chunks) < 3:
        raise RuntimeError(f"{what}: wanted >= 3 chunk lines, got {len(chunks)}:\n" + log[-3000:])
    steady = chunks[1:-1]
    warm = [r for n, r in steady if n == chunk_steps and r > 0] or [r for _, r in steady if r > 0]
    return chunks, round(statistics.median(warm), 2)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--configs", default="1x1,2x1,2x2", help="comma list of PROCSxRANKS")
    parser.add_argument("--repeats", type=int, default=3,
                        help="runs per config; steps/s is the median over repeats of per-run median chunk rates")
    parser.add_argument("--global-batch", type=int, default=32)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--chunk-steps", type=int, default=10)
    parser.add_argument("--targets", type=int, default=2048)
    parser.add_argument("--net", default="tiny3")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (one card per rank) or cpu")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    parser.add_argument("--timeout", type=float, default=1800.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from ..device import resolve_device

    shared = pathlib.Path(tempfile.mkdtemp(prefix="mhs_targets_"))
    try:
        make_targets(shared, args.targets, args.seed, args.net, resolve_device(
            "cpu" if args.device == "cpu" else "cuda"))
        results = []
        for spec in args.configs.split(","):
            procs, devs = (int(x) for x in spec.strip().split("x"))
            reps = []
            for rep in range(args.repeats):
                r = run_config(procs, devs, shared / "targets-selfplay.txt", args.global_batch, args.steps,
                               args.chunk_steps, args.timeout, args.net, args.device, args.backend)
                print(f"{procs}x{devs} rep {rep + 1}/{args.repeats}: {r['steps_per_s']:.1f} steps/s "
                      f"(chunks: {['%.1f' % x for x in r['steps_per_s_all']]})", flush=True)
                reps.append(r)
            agg = dict(reps[0])
            agg["steps_per_s_reps"] = [r["steps_per_s"] for r in reps]
            agg["steps_per_s"] = round(statistics.median(agg["steps_per_s_reps"]), 2)
            agg["steps_per_s_all"] = [r["steps_per_s_all"] for r in reps]
            print(f"{procs}x{devs}: median {agg['steps_per_s']:.1f} steps/s over {args.repeats} repeats", flush=True)
            results.append(agg)
    finally:
        shutil.rmtree(shared, ignore_errors=True)
    base = results[0]["steps_per_s"]
    for r in results[1:]:
        r["vs_first"] = round(r["steps_per_s"] / base, 3)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
