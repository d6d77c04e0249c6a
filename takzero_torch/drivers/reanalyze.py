"""Reanalyze actor driver.

Counterpart of ``takzero_tpu/drivers/reanalyze.py`` (the reference's
reanalyze binary, reanalyze/src/main.rs): wait while the
learner's reanalyze buffer is over its limit, reload ``model_latest.ckpt``
when it changed (and OR the new ``hash_log.bin`` bits into the seen-set),
tail ``replays.txt`` and explode every new replay into all its positions,
sample a batch, search it with fresh trees and beta 0, and append the
fresh targets to ``targets-reanalyze.txt``.

Usage:
    python -m takzero_torch.drivers.reanalyze --directory DIR [--net ...]
        [--seed N] [--max-steps N] [--device cuda|cpu] [--devices N]

With ``--devices N`` (or under ``drivers/multihost.py``) the position
batch is split over N ranks: rank 0 tails the replay files and broadcasts
the lines (every rank keeps the same position buffer and draws the same
sample), each rank searches its rows, and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from ..config import NET_PRESETS, ReanalyzeConfig
from ..data import native_loader as nl
from ..data.buffer import PositionBuffer
from ..models.agent import make_net_evaluate, new_agent
from ..parallel import coordinator as co
from ..parallel import mesh as pm
from ..parallel import multihost
from ..reanalyze import build_targets, make_reanalyze_step
from ..selfplay import gumbel_noise
from ..tak.engine import engine
from ..tak.tps import state_to_tps
from ..utils import ckpt

log = logging.getLogger("reanalyze")


def explode_replays(eng, lines: list[str]) -> list[np.ndarray]:
    """Every position of every replay (target.rs:205-212) as packed int64
    rows, exploded by the C++ loader."""
    if not lines:
        return []
    text = "\n".join(line.rstrip("\n") for line in lines) + "\n"
    rows, _ = nl.parse_replay_rows(eng.n, eng.half_komi, eng.reversible_limit, text)
    return list(rows)


def pack_rows(n: int, states) -> np.ndarray:
    """Batched TakState -> int64[P, state_size] rows (``nl.unpack_states``
    reverses it)."""
    s = n * n
    host = states.map(lambda x: np.asarray(x))
    p = host.height.shape[0]
    buf = np.zeros((p, nl.state_size(n)), np.int64)
    buf[:, :s] = host.height
    buf[:, s : 2 * s] = host.owner
    buf[:, 2 * s : 3 * s] = host.tops
    buf[:, 3 * s : 3 * s + 4] = host.reserves.reshape(p, 4)
    buf[:, 3 * s + 4] = host.to_move
    buf[:, 3 * s + 5] = host.ply
    buf[:, 3 * s + 6] = host.reversible
    return buf


def reanalyze_batch(eng, step, agent, picks: list, gumbel: torch.Tensor, world=None):
    """Search packed positions ``picks`` with fresh trees on ``gumbel``'s
    device and build their targets.  Returns ``(targets, host_seconds)``,
    the host time spent on TPS strings and target rows.  With ``world``
    (a ``parallel.mesh.World``) each rank searches its rows of ``picks``
    and ``gumbel``, and the outputs are gathered: every rank gets every
    target."""
    n = eng.n
    t0 = time.perf_counter()
    states = nl.unpack_states(n, np.stack(picks))
    tps_batch = [state_to_tps(n, states.map(lambda x: x[i])) for i in range(len(picks))]
    host_s = time.perf_counter() - t0
    if world is not None:
        states, gumbel = states.map(world.rows), world.rows(gumbel)
    out = step(states.map(lambda x: x.to(gumbel.device)), agent, gumbel)
    if world is not None:
        out = tuple(world.gather(x) for x in out)
    _, pol, child_actions, ube, value, incomplete = (x.cpu() for x in out)
    t0 = time.perf_counter()
    targets = build_targets(n, tps_batch, pol, child_actions, ube, value, incomplete=incomplete, eng=eng)
    return targets, host_s + time.perf_counter() - t0


def main(argv=None) -> dict:
    """Run the actor; returns its counts and host times: ``steps``
    (searches), ``seconds`` (wall time of the loop), ``explode_seconds``
    (tailing and exploding replays), ``host_seconds`` (TPS strings and
    target rows), ``targets``, ``positions`` (in the buffer at the end)
    and ``reloads``."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--directory", required=True)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-steps", type=int, default=None, help="for tests")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--budget", type=int, default=None)
    parser.add_argument("--sampled", type=int, default=None)
    parser.add_argument("--min-positions", type=int, default=None)
    parser.add_argument("--exploration-positions", type=int, default=0,
                        help="positions per batch drawn from replays-exploration.txt "
                        "(the reference's `exploration` feature, reanalyze:42-47,119-133)")
    parser.add_argument("--exploration-buffer", type=int, default=128_000)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="split the position batch over N ranks, one per card of --device's type (N gloo "
                        "ranks on the CPU), the model whole on each (as drivers/selfplay.py --devices)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = ReanalyzeConfig(
        batch_size=args.batch or ReanalyzeConfig.batch_size,
        search_budget=args.budget or ReanalyzeConfig.search_budget,
        sampled_actions=args.sampled or ReanalyzeConfig.sampled_actions,
        min_positions=args.min_positions if args.min_positions is not None else ReanalyzeConfig.min_positions,
    )
    world = pm.driver_world(parser, args.devices, cfg.batch_size, log, "--batch", args.device)
    if world.launch:
        return pm.launch(main, argv, world, args.device)[0]
    dev = world.device
    multi = multihost if world.active else None
    coord = world.coordinator
    if multi:
        log.info("multihost: rank %d/%d on %s", world.rank, world.size, dev)
        args.seed = multi.broadcast_scalar(args.seed % 2**31)  # rank 0's seed: one sample and draw stream
    net_cfg = NET_PRESETS[args.net]
    n = net_cfg.n
    eng = engine(n, half_komi=net_cfg.half_komi)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # The selfplay actor's child capacity (256 from 6x6 up), so reanalyze
    # truncates no more often than selfplay on the same positions.
    max_children = max(cfg.max_children, 256 if n >= 6 else 0)
    step = make_reanalyze_step(eng, make_net_evaluate(net_cfg, eng, device=dev, world=world), cfg.sampled_actions,
                               cfg.search_budget, max_children, cfg.max_depth, cfg.ube_target_beta)
    agent = new_agent(net_cfg, seed=args.seed, device=dev)
    poller = ckpt.LatestPoller(args.directory)  # each rank polls for itself (drivers/selfplay.py)
    positions = PositionBuffer(rng)
    tail = co.Tailer(args.directory, co.REPLAYS)
    expl_positions = PositionBuffer(rng, max_len=args.exploration_buffer)
    expl_tail = co.Tailer(args.directory, co.REPLAYS_EXPLORATION)

    def tail_lines(tail):
        """New replay lines: rank 0 reads, every rank gets them."""
        lines = tail.read_new_lines() if coord else None
        return multi.broadcast_lines(lines) if multi else lines

    loops = searches = n_targets = 0
    explode_s = host_s = 0.0
    t_loop = time.perf_counter()
    while args.max_steps is None or loops < args.max_steps:
        loops += 1
        max_wait = None if args.max_steps is None else 0.0
        if multi:
            co.coordinated_backpressure(multi, coord, args.directory, cfg.max_reanalyze_buffer, 1, max_wait)
        else:
            co.wait_for_backpressure(args.directory, cfg.max_reanalyze_buffer, which=1, max_wait=max_wait)
        agent, _ = poller.reload_if_changed(agent, log)

        t0 = time.perf_counter()
        positions.extend(explode_replays(eng, tail_lines(tail)))
        if args.exploration_positions:
            expl_positions.extend(explode_replays(eng, tail_lines(expl_tail)))
        explode_s += time.perf_counter() - t0
        if len(positions) < cfg.min_positions:
            if args.max_steps is not None:
                log.info("only %d positions, stopping (test mode)", len(positions))
                break
            log.info("only %d positions, sleeping 60s", len(positions))
            time.sleep(60)
            continue

        t0 = time.perf_counter()
        n_expl = min(args.exploration_positions, len(expl_positions))
        picks = positions.sample(cfg.batch_size - n_expl)
        if n_expl:
            picks = picks + expl_positions.sample(n_expl)
        gumbel = gumbel_noise(gen, (len(picks), max_children))
        t1 = time.perf_counter()
        host_s += t1 - t0
        targets, batch_host_s = reanalyze_batch(eng, step, agent, picks, gumbel, world)
        t2 = time.perf_counter()
        if coord:
            co.append_lines(args.directory, co.TARGETS_REANALYZE, [t.to_line() for t in targets])
        host_s += batch_host_s + time.perf_counter() - t2
        searches += 1
        n_targets += len(targets)
        log.info("step %d: %d targets in %.2fs", loops, len(targets), time.perf_counter() - t1)
    seconds = time.perf_counter() - t_loop
    log.info("reanalyze loop: %d searches in %.3f s, replay explosion %.3f s, host %.3f s",
             searches, seconds, explode_s, host_s)
    return {"steps": searches, "seconds": seconds, "explode_seconds": explode_s, "host_seconds": host_s,
            "targets": n_targets, "positions": len(positions), "reloads": poller.reloads}


if __name__ == "__main__":
    main()
