"""Puzzle benchmark driver.

Counterpart of ``takzero_tpu/drivers/puzzle.py`` (puzzle/src/main.rs):
benchmark a checkpoint on a SQLite database of 6x6 tinue (win-in-N, depths
3/5/7/9) and tinue-avoidance (depths 2/4/6) positions.  Per category:

* solved: the search's best action equals the stored solution;
* proven: tinue, the root is solver-proven a win; avoidance, every root
  child but one is a proven win and the root holds every legal move.

Usage:
    python -m takzero_torch.drivers.puzzle --model CKPT --puzzle-db DB
        [--net net6_simhash] [--sampled-actions 64] [--search-budget 768]
        [--depths 3,5,7,9] [--avoidance-depths 2,4,6] [--device cuda|cpu]
        [--devices N]

With ``--devices N`` each batch of 64 puzzles is split over N ranks, the
model whole on each; the search outputs are gathered, so every rank scores
every puzzle, and rank 0 alone logs.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sqlite3

import torch

from ..config import NET_PRESETS
from ..models.agent import make_net_evaluate, new_agent
from ..parallel import mesh as pm
from ..search import eval as ev
from ..search.core import with_agent
from ..search.gumbel import make_gumbel_search
from ..search.policy import select_best_slot, slot_action
from ..search.tree import init_tree, truncation_stats
from ..selfplay import gumbel_noise
from ..tak.engine import engine
from ..tak.moves import action_to_ptn, ptn_to_action
from ..tak.tps import tps_to_state
from ..train.data import stack_states
from ..utils import ckpt

log = logging.getLogger("puzzle")
BATCH_SIZE = 64
SEED = 12345

TINUE_SQL = """SELECT tps, solution FROM puzzles
JOIN games ON puzzles.game_id = games.id
WHERE games.size = :size
    AND instr(tps, "1C") > 0
    AND instr(tps, "2C") > 0
    AND puzzles.tinue_length = :depth
    AND puzzles.tinue_avoidance_length IS NULL
    AND puzzles.tiltak_2komi_second_move_eval < 0.6
ORDER BY puzzles.game_id ASC"""

AVOIDANCE_SQL = """SELECT tps, solution FROM puzzles
JOIN games ON puzzles.game_id = games.id
WHERE games.size = :size
    AND instr(tps, "1C") > 0
    AND instr(tps, "2C") > 0
    AND puzzles.tinue_avoidance_length = :depth
    AND puzzles.tinue_length IS NULL
    AND puzzles.tiltak_2komi_eval < 0.6
ORDER BY game_id ASC"""


@dataclasses.dataclass
class PuzzleResult:
    category: str
    attempted: int = 0
    solved: int = 0
    proven: int = 0
    # Child truncation: incomplete nodes suppress loss and draw proofs,
    # which the avoidance "proven" metric leans on.
    nodes: int = 0
    nodes_incomplete: int = 0

    def solve_rate(self) -> float:
        return self.solved / self.attempted if self.attempted else 0.0

    def prove_rate(self) -> float:
        return self.proven / self.attempted if self.attempted else 0.0


def fetch_puzzles(db_path, sql, size, depth):
    """``(tps, solution)`` rows; boards without capstones (size < 5) drop
    the capstone filter (puzzle/src/main.rs:132-166)."""
    if size < 5:
        sql = "\n".join(line for line in sql.splitlines() if "instr(tps" not in line)
    con = sqlite3.connect(db_path)
    try:
        rows = con.execute(sql, {"size": size, "depth": depth}).fetchall()
    finally:
        con.close()
    return [(tps, sol) for tps, sol in rows]


def benchmark(eng, search_step, bundle, puzzles, win: bool, n: int, gen: torch.Generator, world=None):
    """Search every puzzle, ``BATCH_SIZE`` at a time (the last batch padded
    with repeats) on ``gen``'s device; ``search_step(envs, bundle, gen) ->
    tree``.  With ``world`` (a ``parallel.mesh.World``) each rank searches
    its rows of a batch and the outputs are gathered."""
    result = PuzzleResult(category="tinue" if win else "avoidance")
    dev = gen.device
    rows = (lambda x: x) if world is None else world.rows  # noqa: E731
    gather = (lambda x: x) if world is None else world.gather  # noqa: E731
    for i in range(0, len(puzzles), BATCH_SIZE):
        chunk = puzzles[i : i + BATCH_SIZE]
        states = [tps_to_state(n, tps) for tps, _ in chunk]
        states += [states[-1]] * (BATCH_SIZE - len(states))
        envs = stack_states(states).map(lambda x: rows(x).to(dev))
        tree = search_step(envs, bundle, gen)
        best, flags, ch_flags, ch_valid, root_complete, trunc = (gather(x).cpu().numpy() for x in (
            slot_action(tree, select_best_slot(tree)), tree.root_flag, tree.child_flag[:, 0, :],
            tree.child_action[:, 0, :] >= 0, ~tree.node_incomplete[:, 0], truncation_stats(tree)))
        trunc = trunc[: len(chunk)]
        result.nodes += int(trunc[:, 0].sum())
        result.nodes_incomplete += int(trunc[:, 1].sum())

        for g, (tps, solution) in enumerate(chunk):
            result.attempted += 1
            try:
                sol_action = ptn_to_action(n, solution)
            except ValueError:
                continue
            if best[g] == sol_action:
                result.solved += 1
            if win:
                proven = flags[g] == ev.WIN
            else:
                # An avoidance proof is sound only when the root examined
                # every legal move (the reference stores all children).
                wins = int(((ch_flags[g] == ev.WIN) & ch_valid[g]).sum())
                proven = bool(root_complete[g]) and wins == int(ch_valid[g].sum()) - 1
            if proven:
                result.proven += 1
            log.debug("tps: %s, selected: %s, solution: %s, solved: %s",
                      tps, action_to_ptn(n, int(best[g])), solution, best[g] == sol_action)
    (log.info if world is None or world.coordinator else log.debug)(
        "%s attempted=%d solved=%d proven=%d solve_rate=%.3f prove_rate=%.3f"
        " truncated_nodes=%d/%d (%.4f%%)",
        result.category, result.attempted, result.solved, result.proven,
        result.solve_rate(), result.prove_rate(), result.nodes_incomplete, result.nodes,
        100.0 * result.nodes_incomplete / max(result.nodes, 1),
    )
    return result


def make_search_step(eng, net_cfg, evaluate, sampled_actions: int, search_budget: int, world=None):
    """``search_step(envs, bundle, gen) -> tree``: one Gumbel search of a
    fresh tree per puzzle, its root draw from ``gen``.  With ``world``,
    ``envs`` are this rank's rows: the draw is made for the whole batch
    and the rank keeps its rows."""
    children = 256 if net_cfg.n >= 6 else 128
    size = 1 if world is None else world.size

    def search_step(envs, bundle, gen):
        search = make_gumbel_search(eng, with_agent(evaluate, bundle), sampled_actions, search_budget, max_depth=48)
        b = envs.ply.shape[0]
        tree = init_tree(eng, envs, search_budget + 8, children)
        gumbel = gumbel_noise(gen, (b * size, children))
        if world is not None:
            gumbel = world.rows(gumbel)
        tree, _ = search(tree, gumbel, torch.zeros((b,), device=envs.ply.device))
        return tree

    return search_step


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True)
    parser.add_argument("--puzzle-db", required=True)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--sampled-actions", type=int, default=64)
    parser.add_argument("--search-budget", type=int, default=768)
    parser.add_argument("--depths", default="3,5,7,9", help="tinue depths, comma-separated")
    parser.add_argument("--avoidance-depths", default="2,4,6")
    parser.add_argument("--filters", type=int, default=None,
                        help="override the preset's core width (checkpoints trained at other sizes)")
    parser.add_argument("--blocks", type=int, default=None)
    parser.add_argument("--hash-bits", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="split each puzzle batch over N ranks, one per card of --device's type (N gloo "
                        "ranks on the CPU), the model whole on each")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    world = pm.driver_world(parser, args.devices, BATCH_SIZE, log, "batch", args.device)
    if world.launch:
        return pm.launch(main, argv, world, args.device)[0]
    dev = world.device

    net_cfg = NET_PRESETS[args.net]
    overrides = {k: v for k, v in (("filters", args.filters), ("blocks", args.blocks),
                                   ("hash_bits", args.hash_bits)) if v is not None}
    if overrides:
        net_cfg = dataclasses.replace(net_cfg, **overrides)
    n = net_cfg.n
    eng = engine(n, half_komi=net_cfg.half_komi)
    bundle = ckpt.load_checkpoint_partial(args.model, new_agent(net_cfg, seed=0, device=dev))
    search_step = make_search_step(eng, net_cfg, make_net_evaluate(net_cfg, eng, device=dev, world=world),
                                   args.sampled_actions, args.search_budget, world)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    results = []
    for sql, depths, win, name in ((TINUE_SQL, args.depths, True, "tinue"),
                                   (AVOIDANCE_SQL, args.avoidance_depths, False, "avoidance")):
        for depth in (int(d) for d in depths.split(",") if d):
            puzzles = fetch_puzzles(args.puzzle_db, sql, n, depth)
            log.info("%s %d: %d puzzles", name, depth, len(puzzles))
            results.append(benchmark(eng, search_step, bundle, puzzles, win, n, gen, world))
    return results


if __name__ == "__main__":
    main()
