"""EEE experiment driver -- offline novelty-estimator studies.

Counterpart of ``takzero_tpu/drivers/eee.py`` (the reference's eee binaries,
eee/src/{rnd,generalization,ensemble,seen_ratio}.rs), with JAX's
subcommands, flags and defaults, on one device:

    python -m takzero_torch.drivers.eee rnd --replays replays.txt
    python -m takzero_torch.drivers.eee generalization --replays replays.txt \
        --novelty simhash|lcghash
    python -m takzero_torch.drivers.eee ensemble --targets targets.txt
    python -m takzero_torch.drivers.eee seen-ratio --model model.ckpt \
        --net net6_simhash

Each writes ``eee_data.csv`` (rnd/generalization/ensemble) or prints a
Python-literal ratio list (seen-ratio), matching the reference's outputs
so its plotting scripts keep working.  Every subcommand takes ``--device``
(default ``cuda``, which raises without CUDA; ``--device cpu`` runs on the
CPU).  ``seen-ratio --model`` reads the port's checkpoint format; a JAX
run's flax msgpack file raises ``ForeignCheckpoint``.  ``--png`` needs
matplotlib.
"""

from __future__ import annotations

import argparse
import logging
import time

from . import refuse_unported

log = logging.getLogger("eee")


def _device_flags(p) -> None:
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--devices", type=int, default=None, help="not ported")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    common = dict(n=4, half_komi=4)

    p = sub.add_parser("rnd")
    p.add_argument("--replays", required=True)
    p.add_argument("--out", default="eee_data.csv")
    p.add_argument("--n", type=int, default=common["n"])
    p.add_argument("--half-komi", type=int, default=common["half_komi"])
    p.add_argument("--steps", type=int, default=45_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=432)
    p.add_argument("--rnd-mlp", action="store_true")
    _device_flags(p)

    p = sub.add_parser("generalization")
    p.add_argument("--replays", required=True)
    p.add_argument("--out", default="eee_data.csv")
    p.add_argument("--n", type=int, default=common["n"])
    p.add_argument("--half-komi", type=int, default=common["half_komi"])
    p.add_argument("--novelty", default="simhash", choices=("simhash", "lcghash"))
    p.add_argument("--hash-bits", type=int, default=26)
    p.add_argument("--steps", type=int, default=45_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=432)
    _device_flags(p)

    p = sub.add_parser("ensemble")
    p.add_argument("--targets", required=True)
    p.add_argument("--out", default="eee_data.csv")
    p.add_argument("--n", type=int, default=common["n"])
    p.add_argument("--half-komi", type=int, default=common["half_komi"])
    p.add_argument("--steps", type=int, default=3_000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--filters", type=int, default=256)
    p.add_argument("--blocks", type=int, default=16)
    p.add_argument("--ensemble-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=1_234_567)
    _device_flags(p)

    p = sub.add_parser("seen-ratio")
    p.add_argument("--model", required=True)
    p.add_argument("--net", default="net6_simhash")
    p.add_argument("--max-ply", type=int, default=100)
    p.add_argument("--batch", type=int, default=65_536)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--csv", default=None, help="write ply,unseen_ratio rows")
    p.add_argument("--png", default=None,
                   help="figures/local_novelty_per_depth.png analog (needs matplotlib)")
    _device_flags(p)

    args = parser.parse_args(argv)
    refuse_unported(args)
    logging.basicConfig(level=logging.INFO)

    if args.cmd == "rnd":
        from ..eee.rnd import run

        return run(
            args.replays,
            args.out,
            n=args.n,
            half_komi=args.half_komi,
            steps=args.steps,
            batch_size=args.batch_size,
            seed=args.seed,
            rnd_mlp=args.rnd_mlp,
            device=args.device,
        )
    if args.cmd == "generalization":
        from ..eee.generalization import run

        return run(
            args.replays,
            args.out,
            n=args.n,
            half_komi=args.half_komi,
            novelty=args.novelty,
            hash_bits=args.hash_bits,
            steps=args.steps,
            batch_size=args.batch_size,
            seed=args.seed,
            device=args.device,
        )
    if args.cmd == "ensemble":
        from ..eee.ensemble import run

        return run(
            args.targets,
            args.out,
            n=args.n,
            half_komi=args.half_komi,
            steps=args.steps,
            batch_size=args.batch_size,
            filters=args.filters,
            blocks=args.blocks,
            ensemble_size=args.ensemble_size,
            seed=args.seed,
            device=args.device,
        )
    import torch

    from ..config import NET_PRESETS
    from ..device import resolve_device
    from ..eee.seen_ratio import run
    from ..models.agent import new_agent
    from ..utils import ckpt

    dev = resolve_device(args.device)
    cfg = NET_PRESETS[args.net]
    bundle = ckpt.load_checkpoint(args.model, new_agent(cfg, seed=0, device=dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pairs = run(bundle, cfg, max_ply=args.max_ply, batch=args.batch, seed=args.seed, device=dev)
    peak = f", peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB" if dev.type == "cuda" else ""
    log.info("seen-ratio: %d plies of %d games in %.3f s%s", args.max_ply, args.batch, time.perf_counter() - t0, peak)
    if args.csv:
        with open(args.csv, "w", encoding="utf-8") as f:
            f.write("ply,unseen_ratio\n")
            f.writelines(f"{p},{r}\n" for p, r in pairs)
    if args.png:
        from ..tools.plots import plot_seen_ratio

        plot_seen_ratio(pairs, args.png)
    return pairs


if __name__ == "__main__":
    main()
