"""Selfplay actor driver.

Counterpart of ``takzero_tpu/drivers/selfplay.py`` (the reference's
selfplay binary, selfplay/src/main.rs): a loop that (1)
waits while the learner's selfplay buffer is over its limit
(``buffer_lengths.txt``), (2) reloads ``model_latest.ckpt`` when it changed
and ORs the new ``hash_log.bin`` bits into its seen-set, (3) plays one
Gumbel move in every game of the batch, (4) appends the finished games'
targets and replays to the shared files.

Usage:
    python -m takzero_torch.drivers.selfplay --directory DIR
        [--net net6_simhash] [--exploration] [--seed N] [--max-steps N]
        [--max-games N] [--profile DIR] [--device cuda|cpu] [--devices N]

With ``--devices N`` (or under ``drivers/multihost.py``) the game batch is
split over N ranks (``selfplay.py``); the seed is rank 0's, backpressure is
rank 0's decision, and rank 0 alone writes.

The text files are byte-compatible with the JAX actor's; the model files
are the port's own format (``takzero_torch/utils/ckpt.py``).
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from ..config import MAX_SELFPLAY_BUFFER_LEN, NET_PRESETS, selfplay_preset
from ..models.agent import make_net_evaluate, new_agent
from ..parallel import coordinator as co
from ..parallel import mesh as pm
from ..parallel import multihost
from ..selfplay import SelfplayEngine, dump_root_line, make_draws
from ..tak.engine import engine
from ..utils import ckpt
from ..utils.profile import StepTrace

log = logging.getLogger("selfplay")


def main(argv=None) -> dict:
    """Run the actor; returns its counts and host times: ``moves``,
    ``seconds`` (wall time of the loop), ``host_seconds`` (the host half
    of ``play_move``: unpacking, TPS strings, policy lists, values),
    ``write_seconds`` (formatting and appending lines), ``targets``,
    ``replays``, ``exploration_replays``, ``reloads`` (weight reloads) and
    ``agent`` (the bundle as the loop left it)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--directory", required=True)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--exploration", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None, help="for tests")
    parser.add_argument("--max-games", type=int, default=None,
                        help="for tests: stop after the move that finishes this many games")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--budget", type=int, default=None)
    parser.add_argument("--sampled", type=int, default=None)
    parser.add_argument("--fresh-tree", action="store_true",
                        help="no tree reuse across moves (the reference descends the chosen subtree)")
    parser.add_argument("--dump-search", default=None,
                        help="append game 0's root children every move to this file "
                        "(takzero_tpu/tools/analyze_search.py reads it)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of moves 2-4 to DIR")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="split the game batch over N ranks, one per card of --device's type (N gloo "
                        "ranks on the CPU), the model whole on each: the analog of the reference's actor "
                        "fleet (SURVEY.md §2.5/§5.7)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    net_cfg = NET_PRESETS[args.net]
    eng = engine(net_cfg.n, half_komi=net_cfg.half_komi)
    overrides = {"exploration": args.exploration}
    if args.batch:
        overrides["batch"] = args.batch
    if args.budget:
        overrides["search_budget"] = args.budget
    if args.sampled:
        overrides["sampled_actions"] = args.sampled
    if args.fresh_tree:
        overrides["tree_reuse"] = False
    sp_cfg = selfplay_preset(args.net, **overrides)
    world = pm.driver_world(parser, args.devices, sp_cfg.batch, log, "--batch", args.device)
    if world.launch:
        return pm.launch(main, argv, world, args.device)[0]
    dev = world.device
    # Under a process group every rank plays its rows of the batch in
    # lockstep and keeps the whole batch's game logs; rank 0 writes.
    multi = multihost if world.active else None
    coord = world.coordinator
    if multi:
        log.info("multihost: rank %d/%d on %s", world.rank, world.size, dev)

    seed = args.seed if args.seed is not None else np.random.SeedSequence().entropy
    seed %= 2**31  # broadcast_scalar carries int32; one rule for every launch
    if multi:
        seed = multi.broadcast_scalar(seed)  # one random stream for every rank
    log.info("seed = %s", seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    sp = SelfplayEngine(eng, sp_cfg, make_net_evaluate(net_cfg, eng, device=dev, world=world), device=dev, world=world)
    sp.reset(make_draws(gen, sp_cfg.batch, sp_cfg.max_children))
    agent = new_agent(net_cfg, seed=int(seed), device=dev)
    # Each rank polls the model files for itself, as in the JAX driver:
    # the ranks agree up to a one-move skew, harmless for data generation
    # and healed at the next poll (no collective depends on it).
    poller = ckpt.LatestPoller(args.directory)
    trace = StepTrace(args.profile if coord else None, log, device=dev)
    counts = {"targets": 0, "replays": 0, "exploration_replays": 0}
    steps, write_s = 0, 0.0
    t_loop = time.perf_counter()
    test_mode = args.max_steps is not None or args.max_games is not None
    while ((args.max_steps is None or steps < args.max_steps)
           and (args.max_games is None or counts["replays"] < args.max_games)):
        trace.step()
        steps += 1
        start = time.time()
        max_wait = 0.0 if test_mode else None
        if multi:
            co.coordinated_backpressure(multi, coord, args.directory, MAX_SELFPLAY_BUFFER_LEN, 0, max_wait)
        else:
            co.wait_for_backpressure(args.directory, MAX_SELFPLAY_BUFFER_LEN, which=0, max_wait=max_wait)
        # Reload before the move is enqueued: the reload writes into the
        # live weights and seen-set.
        agent, reloaded = poller.reload_if_changed(agent, log)
        if reloaded:
            log.info("reloaded model_latest (%.2fs)", time.time() - start)

        targets, replays, exploration_replays = sp.play_move(
            agent, make_draws(gen, sp_cfg.batch, sp_cfg.max_children))
        if args.dump_search and coord:
            # The dump is game 0's root, the first of rank 0's rows: world N
            # writes world 1's line.
            root = {k: v.cpu().numpy() for k, v in sp.last_root.items()}
            with open(args.dump_search, "a", encoding="utf-8") as f:
                f.write(dump_root_line(net_cfg.n, root) + "\n")
        log.info("step %d: move for %d games in %.2fs; %d targets, %d replays",
                 steps, sp_cfg.batch, time.time() - start, len(targets), len(replays))
        if steps % 100 == 0 or steps == args.max_steps:
            exp, inc = sp.truncation_totals
            log.info("truncation: %d/%d nodes incomplete (%.4f%%)", inc, exp, 100.0 * inc / max(exp, 1))
        t_w = time.perf_counter()
        for name, key, items in (
            (co.TARGETS_SELFPLAY, "targets", targets),
            (co.REPLAYS, "replays", replays),
            (co.REPLAYS_EXPLORATION, "exploration_replays", exploration_replays),
        ):
            counts[key] += len(items)
            if not items or not coord:
                continue
            lines = [x.to_line() for x in items]
            try:
                co.append_lines(args.directory, name, lines)
            except OSError as e:  # keep the lines in the log (selfplay/src/main.rs:332-344)
                log.error("cannot append to %s (%s); dumping:\n%s", name, e, "\n".join(lines))
        write_s += time.perf_counter() - t_w
    trace.stop()
    seconds = time.perf_counter() - t_loop
    log.info("selfplay loop: %d moves in %.3f s, host half %.3f s, writing %.3f s",
             steps, seconds, sp.host_seconds, write_s)
    return {"moves": steps, "seconds": seconds, "host_seconds": sp.host_seconds, "write_seconds": write_s,
            **counts, "reloads": poller.reloads, "agent": agent}


if __name__ == "__main__":
    main()
