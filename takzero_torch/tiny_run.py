"""The smallest end-to-end learning check: selfplay, learn, then the trained
net against its own initialisation, in one process.

The port's counterpart of the loop of ``examples/tiny_run.py`` (SURVEY.md
§7), with the same flags and defaults: 3x3, half-komi 0, a 16x2 net with
SimHash over 2^16 bits, selfplay batch 64, budget 48, k=8, lr 1e-3, 150
pre-training steps on random games, 30 iterations of 12 moves and 16 train
steps, then 64 evaluation games played both ways from shared random
openings.  ``--novelty`` picks any of the five estimators (``--rnd-mlp``
for net5's MLP RND), with JAX's sizes: an RND tower of 16 filters and 2
blocks, 8 ensemble heads.  An RND net refreshes its normalization bounds
every 10th iteration that trains, from two fixed batches of random games
(32 positions at ply 4 and 32 at ply 20).

    python -m takzero_torch.tiny_run [--iters 30] [--novelty rnd --beta 0.25] [--out tiny_run.json] [--device cuda|cpu]

Writes a JSON summary: the trained net's wins, losses and draws against
the initial one, the Elo gain from the Bradley-Terry fit
(``tools/elo.py``), the last iteration's loss, the wall time and the card
(``nvidia-smi`` name and power limit).  The train step updates the bundle
in place, so the initial net is a deep copy taken before any step
(weights, BatchNorm statistics and the novelty state).
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from .data.native_loader import make_batch_native
from .device import resolve_device
from .eee.harness import random_plane_batch
from .evaluation import make_compete
from .models.agent import make_net_evaluate, new_agent, rnd_update_normalization
from .models.network import NetConfig
from .search.openings import make_new_opening
from .selfplay import SelfplayConfig, SelfplayEngine, gumbel_noise, make_draws
from .tak.engine import engine
from .tools.elo import MatchResult, fit_elo
from .train.data import random_pretraining_targets
from .train.learner import make_optimizer, make_train_step
from .utils import ckpt

NOVELTY = ("simhash", "lcghash", "rnd", "ensemble", "none")


def card_of(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[dev.index or 0]


def _lines(targets) -> str:
    return "".join(t.to_line() + "\n" for t in targets)


def main(argv=None, on_iteration=None) -> dict:
    """Run the check; returns the summary plus ``train_steps`` (pre-training
    included), ``eval_half_moves`` and both bundles (``agent``,
    ``initial_agent``).  ``on_iteration``, when given, is called with -1
    after pre-training and with each iteration's index after it ends (to
    read the kernels' launch counters around one iteration, say)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--moves-per-iter", type=int, default=12)
    parser.add_argument("--steps-per-iter", type=int, default=16)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--pretrain-steps", type=int, default=150)
    parser.add_argument("--eval-games", type=int, default=64)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--size", type=int, default=3)
    parser.add_argument("--half-komi", type=int, default=0)
    parser.add_argument("--filters", type=int, default=16)
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--budget", type=int, default=48)
    parser.add_argument("--sampled", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--novelty", default="simhash", choices=NOVELTY)
    parser.add_argument("--rnd-mlp", action="store_true", help="net5-style MLP RND instead of the conv tower")
    parser.add_argument("--beta", type=float, default=0.0,
                        help=">0 turns on exploration (beta on half the batch)")
    parser.add_argument("--out", default="tiny_run.json")
    parser.add_argument("--save-ckpt", default=None, help="write the final bundle here")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = NetConfig(n=args.size, half_komi=args.half_komi, filters=args.filters, blocks=args.blocks,
                    novelty=args.novelty, hash_bits=16, rnd_filters=16, rnd_blocks=2, ensemble_size=8,
                    rnd_mlp=args.rnd_mlp)
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    children = 64 if args.size <= 4 else 128
    t0 = time.time()

    bundle = new_agent(cfg, seed=args.seed, device=dev)
    init_bundle = copy.deepcopy(bundle)
    opt = make_optimizer(bundle, args.lr)
    train_step = make_train_step(cfg)

    # Pre-training on random games (learn/src/main.rs:425-483).
    pre = random_pretraining_targets(eng, args.batch * args.pretrain_steps, rng, device=dev)
    for i in range(args.pretrain_steps):
        batch = make_batch_native(eng, _lines(pre[i * args.batch : (i + 1) * args.batch]), rng, device=dev)
        m = train_step(bundle, opt, batch, train_ube=False)
    if args.pretrain_steps:
        print(f"pretrain done ({time.time() - t0:.0f}s): loss={float(m['loss']):.3f}", flush=True)

    sp_cfg = SelfplayConfig(batch=args.batch, search_budget=args.budget, sampled_actions=args.sampled,
                            beta=args.beta, exploration=args.beta > 0, max_children=children, max_depth=40)
    evaluator = make_net_evaluate(cfg, eng, device=dev)
    sp = SelfplayEngine(eng, sp_cfg, evaluator, device=dev)
    sp.reset(make_draws(gen, args.batch, children))
    if cfg.novelty == "rnd":
        rnd_refs = tuple(random_plane_batch(eng, torch.Generator(device=dev).manual_seed(seed), ply, 32)
                         for seed, ply in ((9, 4), (10, 20)))
    buffer: list = []
    losses = []
    train_steps = 0
    if on_iteration is not None:
        on_iteration(-1)
    for it in range(args.iters):
        for _ in range(args.moves_per_iter):
            targets, _, _ = sp.play_move(bundle, make_draws(gen, args.batch, children))
            buffer.extend(targets)
        buffer = buffer[-20_000:]
        if len(buffer) >= args.batch:
            for _ in range(args.steps_per_iter):
                picks = [buffer[i] for i in rng.integers(0, len(buffer), args.batch)]
                m = train_step(bundle, opt, make_batch_native(eng, _lines(picks), rng, device=dev), train_ube=True)
                train_steps += 1
            losses.append(float(m["loss"]))
            if cfg.novelty == "rnd" and it % 10 == 0:
                rnd_update_normalization(cfg, bundle, *rnd_refs)
            print(f"iter {it}: buffer={len(buffer)} loss={losses[-1]:.3f} ({time.time() - t0:.0f}s)", flush=True)
        if on_iteration is not None:
            on_iteration(it)

    # Final against initial, both colours from shared random openings.
    compete = make_compete(eng, evaluator, sampled_actions=args.sampled, search_budget=args.budget,
                           max_children=children, max_depth=40)
    e = args.eval_games
    envs = make_new_opening(eng, random_steps=1)(
        torch.randint(0, 8, (e,), generator=gen, device=dev), torch.randint(0, 2, (e,), generator=gen, device=dev),
        gumbel_noise(gen, (1, e, eng.num_actions)),
    )
    r1 = compete(bundle, init_bundle, envs, gen)  # trained as white
    r2 = compete(init_bundle, bundle, envs, gen)  # trained as black
    wins, losses_, draws = r1.wins + r2.losses, r1.losses + r2.wins, r1.draws + r2.draws
    ratings = fit_elo([
        MatchResult("run", 1, "run", 0, r1.wins, r1.losses, r1.draws),
        MatchResult("run", 0, "run", 1, r2.wins, r2.losses, r2.draws),
    ])
    summary = {
        "wins": wins,
        "losses": losses_,
        "draws": draws,
        "games": wins + losses_ + draws,
        "elo_gain": round(ratings["run_1"][0] - ratings["run_0"][0], 1),
        "final_loss": losses[-1] if losses else None,
        "wall_s": round(time.time() - t0, 1),
        "card": card_of(dev),
    }
    print(json.dumps(summary), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1), encoding="utf-8")
    if args.save_ckpt:
        path = pathlib.Path(args.save_ckpt)
        ckpt.save_checkpoint(path.parent, path.name, bundle)
    return {**summary, "train_steps": args.pretrain_steps + train_steps,
            "eval_half_moves": r1.half_moves + r2.half_moves, "agent": bundle, "initial_agent": init_bundle}


if __name__ == "__main__":
    main()
