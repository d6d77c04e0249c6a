"""Evaluation driver: round-robin pit fighter over checkpoints.

Counterpart of ``takzero_tpu/drivers/evaluation.py`` (evaluation/src/main.rs):
scan the model directory for numbered checkpoints, sample two, play both
colours from a batch of random (or book) openings, and log
``{a} vs. {b}: Evaluation {{ wins, losses, draws }} {rate}%`` lines for the
Elo tooling, byte for byte as the JAX driver does.

Usage:
    python -m takzero_torch.drivers.evaluation --model-path DIR [--net ...]
        [--opening-book FILE] [--games N] [--step K] [--rounds N]
        [--pair A.ckpt,B.ckpt] [--fresh-tree] [--seed N]
        [--rss-limit-gb G] [--device cuda|cpu] [--devices N]

With ``--devices N`` the game batch is split over N ranks, both models
whole on each (``evaluation.py``); the seed is rank 0's and rank 0 alone
logs the result lines, so the Elo tooling reads each match once.

Checkpoints are the port's own format (``takzero_torch/utils/ckpt.py``).
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import re
import time

import numpy as np
import torch

from ..config import NET_PRESETS
from ..evaluation import make_compete
from ..models.agent import make_net_evaluate, new_agent
from ..parallel import mesh as pm
from ..parallel import multihost
from ..search.openings import make_new_opening
from ..selfplay import gumbel_noise
from ..tak.engine import engine
from ..tak.tps import tps_to_state
from ..train.data import stack_states
from ..utils import ckpt, watchdog

log = logging.getLogger("evaluation")
_NUMBERED = re.compile(r"model_(\d+)\.ckpt$")


def scan_checkpoints(model_path, step: int) -> list[pathlib.Path]:
    paths = sorted(p for p in pathlib.Path(model_path).iterdir() if _NUMBERED.search(p.name))
    return paths[::step]


def build_openings(eng, n_games, rng: np.random.Generator, device, opening_book=None):
    """``n_games`` openings: lines of the book drawn with ``rng``, or the
    reference opening plus 2-3 random plies (evaluation:199-205), its draws
    from a generator seeded by ``rng``."""
    if opening_book:
        lines = pathlib.Path(opening_book).read_text().splitlines()
        idx = rng.integers(0, len(lines), n_games)
        return stack_states([tps_to_state(eng.n, lines[i]) for i in idx]).map(lambda x: x.to(device))
    steps = int(rng.integers(2, 4))
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
    sym = torch.randint(0, 8, (n_games,), generator=gen, device=device)
    pair = torch.randint(0, 2, (n_games,), generator=gen, device=device)
    gumbel = gumbel_noise(gen, (steps, n_games, eng.num_actions))
    return make_new_opening(eng, random_steps=steps)(sym, pair, gumbel)


def main(argv=None) -> list:
    """Run the pit fighter; returns the ``(a, b, Evaluation)`` of every
    match played."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--opening-book", default=None)
    parser.add_argument("--step", type=int, default=1, help="take every k-th ckpt")
    parser.add_argument("--games", type=int, default=64)
    parser.add_argument("--budget", type=int, default=768)
    parser.add_argument("--sampled", type=int, default=64)
    parser.add_argument("--max-moves", type=int, default=200)
    parser.add_argument("--rounds", type=int, default=None, help="for tests")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--pair", default=None, metavar="A.ckpt,B.ckpt",
                        help="play exactly this checkpoint pair (both colours) and exit, so that a "
                        "supervisor (tools/elo_curve.py) bounds each subprocess's lifetime")
    parser.add_argument("--rss-limit-gb", type=float, default=48.0,
                        help="hard-exit (code 42) when host RSS exceeds this; 0 disables")
    parser.add_argument("--fresh-tree", action="store_true", help="disable cross-move tree reuse for both agents")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="split the game batch over N ranks, one per card of --device's type (N gloo "
                        "ranks on the CPU), both models whole on each (as drivers/selfplay.py --devices)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    world = pm.driver_world(parser, args.devices, args.games, log, "--games", args.device)
    if world.launch:
        return pm.launch(main, argv, world, args.device)[0]
    dev = world.device
    coord = world.coordinator
    watchdog.start_rss_watchdog(args.rss_limit_gb)

    net_cfg = NET_PRESETS[args.net]
    eng = engine(net_cfg.n, half_komi=net_cfg.half_komi)
    seed = args.seed if args.seed is not None else int(time.time())
    if world.active:
        seed = multihost.broadcast_scalar(seed % 2**31)  # every rank opens the same games
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63)

    compete = make_compete(
        eng, make_net_evaluate(net_cfg, eng, device=dev, world=world), args.sampled, args.budget,
        max_children=256 if net_cfg.n >= 6 else 128, tree_reuse=not args.fresh_tree,
        world=world,
    )

    results = []
    rounds = 0
    max_rounds = 1 if args.pair else args.rounds
    while max_rounds is None or rounds < max_rounds:
        rounds += 1
        if args.pair:
            na, nb = args.pair.split(",")
            pa = pathlib.Path(args.model_path) / na
            pb = pathlib.Path(args.model_path) / nb
        else:
            paths = scan_checkpoints(args.model_path, args.step)
            if world.active:  # a learner may be writing: every rank takes rank 0's listing
                paths = [pathlib.Path(args.model_path) / name
                         for name in multihost.broadcast_lines([p.name for p in paths] if coord else None)]
            if len(paths) < 2:
                if max_rounds is not None:
                    log.info("too few models (%d), stopping", len(paths))
                    return results
                log.info("too few models, sleeping 600s")
                time.sleep(600)
                continue
            pa, pb = (paths[i] for i in rng.choice(len(paths), 2, replace=False))
        try:
            a = ckpt.load_checkpoint_partial(pa, new_agent(net_cfg, seed=0, device=dev))
            b = ckpt.load_checkpoint_partial(pb, new_agent(net_cfg, seed=0, device=dev))
        except Exception as e:  # a bad file must not end a round-robin
            if args.pair:
                raise  # a supervisor must see a nonzero exit, not silence
            log.warning("cannot load %s/%s: %s", pa, pb, e)
            continue

        envs = build_openings(eng, args.games, rng, dev, args.opening_book)
        r1 = compete(a, b, envs, gen, args.max_moves)
        if coord:
            log.info("%s vs. %s: %s %.1f%%", pa.name, pb.name, r1, r1.win_rate() * 100)
        r2 = compete(b, a, envs, gen, args.max_moves)
        if coord:
            log.info("%s vs. %s: %s %.1f%%", pb.name, pa.name, r2, r2.win_rate() * 100)
        results += [(pa.name, pb.name, r1), (pb.name, pa.name, r2)]
        del a, b
    return results


if __name__ == "__main__":
    main()
