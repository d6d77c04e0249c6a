"""A/B: carried-subtree vs fresh-tree search at equal budget.

Counterpart of ``takzero_tpu/tools/reuse_ab.py``.  The reference always
keeps the chosen child's subtree across moves (node/batched.rs:131-144);
whether reuse buys strength at a given config is an empirical question.
This pits one bundle against itself — one side descending its tree between
moves, the other rebuilding fresh — over both-colour games from shared
random openings, and reports W/L/D + score for the REUSING side.  As in
JAX, both directions start from the same openings and the same draws.

    python -m takzero_torch.tools.reuse_ab --ckpt model.ckpt \
        --net net6_simhash [--games 64] [--budget 768] [--sampled 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import torch

from ..config import NET_PRESETS, selfplay_preset
from ..device import resolve_device
from ..evaluation import make_compete
from ..models.agent import make_net_evaluate, new_agent
from ..search.openings import make_new_opening
from ..selfplay import gumbel_noise
from ..tak.engine import engine
from ..utils import ckpt

log = logging.getLogger("reuse_ab")

# (white reuses, black reuses) per direction: the reusing side is white in
# direction 0 and black in direction 1.
DIRECTIONS = ((True, False), (False, True))
RANDOM_STEPS = 2  # random plies after the reference opening


def play_directions(eng, evaluator, sp, bundle, openings, draws, max_moves: int) -> list[dict]:
    """The reusing side's W/L/D (and the half-moves searched) in each
    direction.  ``openings[i]`` is direction i's batch of positions;
    ``draws[i]`` its Gumbel draws: a ``torch.Generator``, or a sequence of
    per-half-move f32[B, max_children] (a test replays JAX's)."""
    out = []
    for direction, reuse_pair in enumerate(DIRECTIONS):
        compete = make_compete(eng, evaluator, sp.sampled_actions, sp.search_budget, sp.max_children,
                               sp.max_depth, tree_reuse=reuse_pair)
        d = draws[direction]
        gen = d if isinstance(d, torch.Generator) else None
        res = compete(bundle, bundle, openings[direction], gen, max_moves=max_moves,
                      draws=None if gen is not None else d)
        # `res` scores WHITE; direction 1 has the reusing agent as black.
        w, l, dr = (res.wins, res.losses, res.draws) if direction == 0 else (res.losses, res.wins, res.draws)
        log.info("direction %d (reuse as %s): %dW-%dL-%dD", direction, "white" if direction == 0 else "black",
                 w, l, dr)
        out.append({"wins": w, "losses": l, "draws": dr, "half_moves": res.half_moves})
    return out


def random_openings(eng, games: int, seed: int, device):
    """``games`` reference openings plus two random plies, drawn from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sym = torch.randint(0, 8, (games,), generator=gen, device=device)
    pair = torch.randint(0, 2, (games,), generator=gen, device=device)
    gumbel = gumbel_noise(gen, (RANDOM_STEPS, games, eng.num_actions))
    return make_new_opening(eng, random_steps=RANDOM_STEPS)(sym, pair, gumbel)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--net", default="net6_simhash", choices=NET_PRESETS)
    p.add_argument("--games", type=int, default=64, help="games per color direction (total = 2x)")
    p.add_argument("--budget", type=int, default=None)
    p.add_argument("--sampled", type=int, default=None)
    p.add_argument("--max-moves", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write a JSON summary here")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)

    net_cfg = NET_PRESETS[args.net]
    eng = engine(net_cfg.n, half_komi=net_cfg.half_komi)
    sp = selfplay_preset(
        args.net,
        **{k: v for k, v in (("search_budget", args.budget), ("sampled_actions", args.sampled)) if v},
    )
    bundle = ckpt.load_checkpoint(args.ckpt, new_agent(net_cfg, seed=0, device=dev))
    evaluator = make_net_evaluate(net_cfg, eng, device=dev)

    t0 = time.time()
    envs = random_openings(eng, args.games, args.seed, dev)
    gens = [torch.Generator(device=dev).manual_seed(args.seed + 1) for _ in DIRECTIONS]
    per = play_directions(eng, evaluator, sp, bundle, (envs, envs), gens, args.max_moves)
    wins, losses, draws = (sum(r[k] for r in per) for k in ("wins", "losses", "draws"))
    n = wins + losses + draws
    score = (wins + 0.5 * draws) / max(n, 1)
    summary = {
        "net": args.net, "games": n, "budget": sp.search_budget,
        "sampled": sp.sampled_actions, "max_children": sp.max_children,
        "reuse_wins": wins, "reuse_losses": losses, "draws": draws,
        "reuse_score": round(score, 4), "wall_s": round(time.time() - t0, 1),
        "half_moves": sum(r["half_moves"] for r in per),
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
