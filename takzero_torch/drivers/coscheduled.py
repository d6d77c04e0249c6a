"""Co-scheduled actor and learner: one job, no weight files.

Counterpart of ``takzero_tpu/drivers/coscheduled.py``.  The reference
decouples one learner from its actors over a shared filesystem (actors poll
``model_latest.ot``; selfplay/src/main.rs:107-120, SURVEY.md §5.8).  Here
the learner and a selfplay actor share one process (one per rank) and its card: the
train step updates the bundle in place, and the very next ``play_move``
reads those tensors, with no file, no poll and no staleness.

The fleet files are still written (``targets-selfplay.txt``,
``replays.txt``, ``replays-exploration.txt``, ``targets-reanalyze.txt``,
``targets-initial.txt``, ``buffer_lengths.txt``), by rank 0 alone, with ``hash_log.bin``
flushed before any checkpoint is written, a weights-only
``model_latest.ckpt`` every 100 steps and step checkpoints at
``--steps-per-checkpoint``, so external reanalyze, evaluation or puzzle
jobs can join a co-scheduled run.

``--reanalyze`` adds the reference's third process: replays are exploded
in-process, and once ``--reanalyze-min-positions`` positions exist
(reanalyze/src/main.rs:38) one fresh-tree beta=0 reanalyze batch runs per
selfplay move; after ``--steps-before-reanalyze`` optimizer steps
(learn/src/main.rs:54-58) train batches are the reference's 64+64
selfplay+reanalyze mix.  ``--pretrain-steps`` runs the learner's
random-game pre-training (learn/src/main.rs:139-171) before the loop.
As in the JAX driver, an RND net's normalization bounds are never
refreshed here (they stay at 0 and 1; ``drivers/learn.py`` refreshes them).

With ``--devices N`` the job is N ranks: each plays its rows of the game
batch, trains on its rows of every train batch and searches its rows of
every reanalyze batch; the gathered host buffers keep every rank's target
buffers, and so its batches and weights, identical.

Usage:
    python -m takzero_torch.drivers.coscheduled --directory DIR
        [--net net6_simhash] [--steps-per-move K] [--max-moves N]
        [--batch B] [--budget N] [--sampled K] [--reanalyze]
        [--pretrain-steps N] [--device cuda|cpu] [--devices N]
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import time

import numpy as np
import torch

from ..config import NET_PRESETS, LearnConfig, ReanalyzeConfig, selfplay_preset
from ..data.buffer import PositionBuffer, TargetBuffer
from ..data.native_loader import make_batch_native
from ..models.agent import HASHED, hash_indices_fresh, make_net_evaluate, new_agent
from ..parallel import coordinator as co
from ..parallel import mesh as pm
from ..parallel import multihost
from ..reanalyze import make_reanalyze_step
from ..selfplay import SelfplayEngine, gumbel_noise, make_draws
from ..tak.engine import engine
from ..train.learner import make_optimizer, make_train_step
from ..utils import ckpt
from ..utils.flush import drain_index_pairs
from .learn import pretrain
from .reanalyze import explode_replays, reanalyze_batch

log = logging.getLogger("coscheduled")


class GeneratorDraws:
    """The loop's random draws, all from one ``torch.Generator``, in the
    order the loop asks: the openings, then per move the move's draws and,
    when it runs, the reanalyze batch's root Gumbels.  A test replaces it
    with an object of the same methods that replays another chain."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def move(self, batch: int, children: int) -> dict:
        return make_draws(self.gen, batch, children)

    opening = move

    def search(self, batch: int, children: int) -> torch.Tensor:
        return gumbel_noise(self.gen, (batch, children))


def main(argv=None, draws=None) -> dict:
    """Run the loop; ``draws`` replaces the driver's :class:`GeneratorDraws`.

    Returns the loop's counts and host times: ``moves``, ``train_steps``
    (in the loop), ``pretrain_steps``, ``mixed_steps`` (64+64 batches),
    ``reanalyze_batches``, ``targets`` (selfplay), ``reanalyze_targets``,
    ``replays``, ``exploration_replays``, ``seconds`` (wall time of the
    loop), ``selfplay_seconds``, ``reanalyze_seconds`` and
    ``train_seconds`` (host clock; the train steps' device work is waited
    for by the next move's readback), ``model_steps``,
    ``final_metrics`` (the last step's, as floats), ``nonfinite_steps``
    (steps with a non-finite metric) and ``agent`` (the bundle)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--directory", required=True)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--devices", type=int, default=None,
                        help="split the game, train and reanalyze batches over N ranks, one per card of "
                        "--device's type (N gloo ranks on the CPU)")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--budget", type=int, default=None)
    parser.add_argument("--sampled", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None, help="learner batch size")
    parser.add_argument("--steps-per-move", type=int, default=1,
                        help="optimizer steps attempted after each selfplay move "
                        "(skipped while the target buffer is short)")
    parser.add_argument("--max-moves", type=int, default=None, help="for tests")
    parser.add_argument("--steps-per-checkpoint", type=int, default=None,
                        help="immutable checkpoint cadence (default 50000)")
    parser.add_argument("--reanalyze", action="store_true",
                        help="run the reanalyze actor in-process: one fresh-tree beta=0 batch per move "
                        "once enough replay positions exist, mixed 64+64 into train batches after "
                        "--steps-before-reanalyze")
    parser.add_argument("--steps-before-reanalyze", type=int, default=None)
    parser.add_argument("--reanalyze-min-positions", type=int, default=None,
                        help="replay positions required before reanalyze starts "
                        "(default 128000, reanalyze/src/main.rs:38)")
    parser.add_argument("--reanalyze-batch", type=int, default=None)
    parser.add_argument("--exploration", action="store_true",
                        help="beta=0.25 on the first half of the selfplay batch (the reference's "
                        "`exploration` cargo feature, selfplay/src/main.rs:81-87)")
    parser.add_argument("--pretrain-steps", type=int, default=0,
                        help="pre-training steps on random-game targets before the loop "
                        "(learn/src/main.rs:139-171); 0 disables")
    parser.add_argument("--pretrain-targets", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    net_cfg = NET_PRESETS[args.net]
    eng = engine(net_cfg.n, half_komi=net_cfg.half_komi)
    cfg = LearnConfig(
        batch_size=args.batch_size or LearnConfig.batch_size,
        steps_per_checkpoint=args.steps_per_checkpoint or LearnConfig.steps_per_checkpoint,
        steps_before_reanalyze=args.steps_before_reanalyze or LearnConfig.steps_before_reanalyze,
        pre_training_steps=args.pretrain_steps,
        initial_random_targets=args.pretrain_targets or LearnConfig.initial_random_targets,
    )

    overrides = {"exploration": args.exploration}
    if args.batch:
        overrides["batch"] = args.batch
    if args.budget:
        overrides["search_budget"] = args.budget
    if args.sampled:
        overrides["sampled_actions"] = args.sampled
    sp_cfg = selfplay_preset(args.net, **overrides)
    world = pm.driver_world(parser, args.devices, sp_cfg.batch, log, "--batch", args.device)
    if cfg.batch_size % world.size:
        parser.error(f"--batch-size {cfg.batch_size} not divisible by --devices {world.size}")
    if world.launch:
        return pm.launch(main, argv, world, args.device)[0]
    dev = world.device
    coord = world.coordinator
    if world.active:
        log.info("multihost: rank %d/%d on %s", world.rank, world.size, dev)
        args.seed = multihost.broadcast_scalar(args.seed % 2**31)  # rank 0's seed: one stream for every rank
    rng = np.random.default_rng(args.seed)
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=dev).manual_seed(args.seed))
    evaluator = make_net_evaluate(net_cfg, eng, device=dev, world=world)
    sp = SelfplayEngine(eng, sp_cfg, evaluator, device=dev, world=world)
    sp.reset(draws.opening(sp_cfg.batch, sp_cfg.max_children))
    train_step = make_train_step(net_cfg, world)
    hash_logged = net_cfg.novelty in HASHED

    bundle = new_agent(net_cfg, seed=args.seed, device=dev)
    bundle, steps = ckpt.resume_with_hash_log(args.directory, bundle, log, reconcile=hash_logged and coord)
    # Every rank has resumed before rank 0 writes the first checkpoint.
    if world.active and multihost.broadcast_scalar(steps) != steps:
        raise RuntimeError(f"rank {world.rank} resumed at step {steps}, rank 0 elsewhere")
    opt = make_optimizer(bundle, cfg.learning_rate)
    if steps == 0 and coord:
        ckpt.save_checkpoint(args.directory, "model_0000000.ckpt", bundle)
    pretrain_steps = 0
    if steps == 0 and cfg.pre_training_steps > 0:
        pretrain_steps, pairs = pretrain(args.directory, eng, net_cfg, cfg, bundle, opt, train_step, rng, dev,
                                         world)
        steps += pretrain_steps
        if coord:
            if pairs:
                ckpt.append_hash_indices(args.directory, drain_index_pairs(pairs))
            ckpt.save_checkpoint(args.directory, f"model_{steps:07d}.ckpt", bundle)

    buffer = TargetBuffer(rng)
    re_buffer = TargetBuffer(rng)
    if args.reanalyze:
        re_cfg = ReanalyzeConfig(
            batch_size=args.reanalyze_batch or ReanalyzeConfig.batch_size,
            search_budget=sp_cfg.search_budget,
            sampled_actions=sp_cfg.sampled_actions,
            min_positions=(args.reanalyze_min_positions if args.reanalyze_min_positions is not None
                           else ReanalyzeConfig.min_positions),
        )
        re_children = max(re_cfg.max_children, sp_cfg.max_children)
        re_step = make_reanalyze_step(eng, evaluator, re_cfg.sampled_actions, re_cfg.search_budget,
                                      re_children, re_cfg.max_depth, re_cfg.ube_target_beta)
        re_positions = PositionBuffer(rng)
        if re_cfg.batch_size % world.size:
            parser.error(f"--reanalyze-batch {re_cfg.batch_size} not divisible by --devices {world.size}")
        replays_path = pathlib.Path(args.directory) / co.REPLAYS
        if steps > 0 and replays_path.exists():
            # On a restart the reference reanalyze re-tails replays.txt from
            # the start (SURVEY.md §7 L7): reseed from the file's tail so the
            # 64+64 mix does not starve for ~min_positions moves.
            lines = replays_path.read_text(encoding="utf-8").splitlines()[-600:]
            re_positions.extend(explode_replays(eng, lines))
            log.info("reseeded %d reanalyze positions from %d stored replays", len(re_positions), len(lines))

    saver = ckpt.AsyncSaver()
    trained_pairs: list = []
    counts = dict(moves=0, train_steps=0, mixed_steps=0, reanalyze_batches=0, targets=0, reanalyze_targets=0,
                  replays=0, exploration_replays=0)
    sp_s = re_s = train_s = 0.0
    metrics, nonfinite = None, torch.zeros((), dtype=torch.int64, device=dev)
    t_loop = time.perf_counter()
    while args.max_moves is None or counts["moves"] < args.max_moves:
        counts["moves"] += 1
        t0 = time.perf_counter()
        targets, replays, exploration_replays = sp.play_move(bundle, draws.move(sp_cfg.batch, sp_cfg.max_children))
        lines = [t.to_line() for t in targets]
        buffer.extend(lines, cfg.selfplay_forced_uses, steps)
        replay_lines = [r.to_line() for r in replays]
        for name, items in ((co.TARGETS_SELFPLAY, lines), (co.REPLAYS, replay_lines),
                            (co.REPLAYS_EXPLORATION, [r.to_line() for r in exploration_replays])):
            if items and coord:
                co.append_lines(args.directory, name, items)
        counts["targets"] += len(targets)
        counts["replays"] += len(replays)
        counts["exploration_replays"] += len(exploration_replays)
        t1 = time.perf_counter()
        sp_s += t1 - t0

        re_targets = 0
        if args.reanalyze:
            if replay_lines:
                re_positions.extend(explode_replays(eng, replay_lines))
            if len(re_positions) >= re_cfg.min_positions and len(re_buffer) < re_cfg.max_reanalyze_buffer:
                picks = re_positions.sample(re_cfg.batch_size)
                found, _ = reanalyze_batch(eng, re_step, bundle, picks, draws.search(len(picks), re_children),
                                           world)
                re_lines = [t.to_line() for t in found]
                re_buffer.extend(re_lines, cfg.reanalyze_forced_uses, steps)
                if coord:
                    co.append_lines(args.directory, co.TARGETS_REANALYZE, re_lines)
                re_targets = len(re_lines)
                counts["reanalyze_batches"] += 1
                counts["reanalyze_targets"] += re_targets
        t_move = time.perf_counter() - t0
        re_s += t_move - (t1 - t0)

        t2 = time.perf_counter()
        trained = 0
        for _ in range(args.steps_per_move):
            # After the switch-on the reference learner trains on mixed
            # 64+64 batches only, sleeping while either stream is starved
            # (learn/src/main.rs:54-58): here a starved stream skips the
            # step and selfplay and reanalyze go on filling.
            mix = args.reanalyze and steps + 1 >= cfg.steps_before_reanalyze
            if mix:
                half = cfg.batch_size // 2
                if len(buffer) < half or len(re_buffer) < half:
                    break
                drained = buffer.drain_batch(half) + re_buffer.drain_batch(half)
            else:
                if len(buffer) < cfg.batch_size:
                    break
                drained = buffer.drain_batch(cfg.batch_size)
            batch = world.rows(make_batch_native(eng, "\n".join(drained) + "\n", rng, device=dev))
            if hash_logged:
                # Before the step, whose hash_update sets these bits in place.
                trained_pairs.append(hash_indices_fresh(net_cfg, bundle, batch.planes, world))
            metrics = train_step(bundle, opt, batch, train_ube=True)
            nonfinite += ~torch.isfinite(torch.stack(list(metrics.values()))).all()
            steps += 1
            trained += 1
            counts["mixed_steps"] += int(mix)
            at_save = steps % cfg.steps_per_save == 0
            at_ckpt = steps % cfg.steps_per_checkpoint == 0
            if (at_save or at_ckpt) and trained_pairs:
                # hash_log.bin at least as fresh as any artifact written now:
                # external pollers replay it to track the seen-set.
                if coord:
                    ckpt.append_hash_indices(args.directory, drain_index_pairs(trained_pairs))
                trained_pairs.clear()
            if at_save and coord:
                saver.submit(args.directory, "model_latest.ckpt", ckpt.strip_hash_bits(bundle))
            if at_ckpt and coord:
                saver.submit(args.directory, f"model_{steps:07d}.ckpt", bundle)
        counts["train_steps"] += trained
        train_s += time.perf_counter() - t2
        if coord:
            co.write_buffer_lengths(args.directory, len(buffer), len(re_buffer))
        log.info(
            "move %d: %.2fs search (+%d train steps, %.2fs total); buffer=%d re_buffer=%d, %d targets, "
            "%d re-targets, %d replays, model step %d",
            counts["moves"], t_move, trained, time.perf_counter() - t0, len(buffer), len(re_buffer),
            len(targets), re_targets, len(replays), steps,
        )

    if coord:
        if trained_pairs:
            ckpt.append_hash_indices(args.directory, drain_index_pairs(trained_pairs))
        saver.submit(args.directory, "model_latest.ckpt", ckpt.strip_hash_bits(bundle))
        saver.submit(args.directory, f"model_{steps:07d}.ckpt", bundle)
    saver.drain()
    seconds = time.perf_counter() - t_loop
    log.info("coscheduled loop: %d moves, %d train steps in %.3f s (selfplay %.3f s, reanalyze %.3f s, "
             "train %.3f s)", counts["moves"], counts["train_steps"], seconds, sp_s, re_s, train_s)
    return {
        **counts, "pretrain_steps": pretrain_steps, "model_steps": steps, "seconds": seconds,
        "selfplay_seconds": sp_s, "reanalyze_seconds": re_s, "train_seconds": train_s,
        "final_metrics": None if metrics is None else {k: float(v) for k, v in metrics.items()},
        "nonfinite_steps": int(nonfinite), "agent": bundle,
    }


if __name__ == "__main__":
    main()
