"""Learner driver.

Counterpart of ``takzero_tpu/drivers/learn.py`` (the reference's learn
binary, learn/src/main.rs): resume from the highest-step
checkpoint (or a fresh init and pre-training on random games), then loop:
tail the two target files, publish the buffer lengths, draw a batch
(64 + 64 once reanalyze joins at step 5000), augment it, take one
optimizer step, save ``model_latest.ckpt`` every 100 steps and an
immutable checkpoint every 50000.  Metrics go to ``metrics.jsonl`` one
chunk late, so the host reads the device only after it queued the next
chunk; the bits each batch newly sets in the hash seen-set (SimHash, LCG
hash) go to ``hash_log.bin``.  RND nets refresh their normalization bounds
from two fixed reference batches of random games (ply 8 and ply 60, 64
positions each) once before the loop and after every chunk that ends on
a multiple of 100 steps (learn/src/rnd_normalization.rs:48-77).

With ``TAKZERO_LEARN_TIMING`` set, every chunk logs JAX's
``chunk timing: assemble=... stack+dispatch=... flush=... (c=N)`` line:
the host's batch assembly, the hash and train-step dispatch, and the
previous chunk's metric read.

With ``--devices N`` (or under ``drivers/multihost.py``) the learner is N
data-parallel ranks: each trains on its rows of every batch
(``train/learner.py``), rank 0 alone tails the target files and
broadcasts the lines, and rank 0 alone writes.

Usage:
    python -m takzero_torch.drivers.learn --directory DIR [--net ...]
        [--restart-targets FILE] [--max-steps N] [--device cuda|cpu]
        [--devices N]

The run directory's files are those of the JAX learner; the model files
are the port's own format (``takzero_torch/utils/ckpt.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ..config import NET_PRESETS, LearnConfig
from ..data.buffer import TargetBuffer
from ..data.native_loader import make_batch_native, valid_target_lines
from ..eee.harness import random_plane_batch
from ..models.agent import HASHED, hash_indices_fresh, new_agent, rnd_update_normalization
from ..parallel import coordinator as co
from ..parallel import mesh as pm
from ..parallel import multihost
from ..tak.engine import engine
from ..train.data import random_pretraining_targets
from ..train.learner import make_optimizer, make_train_step, make_train_step_chunk
from ..utils import ckpt
from ..utils.profile import StepTrace

log = logging.getLogger("learn")


def chunk_len(model_steps: int, chunk_steps: int, cfg, cross_reanalyze: bool,
              target_steps: int | None) -> int:
    """Steps in the next chunk.

    Chunks never cross a save boundary, an immutable-checkpoint boundary,
    the reanalyze switch-on, or the step target.
    """
    c = min(
        chunk_steps,
        cfg.steps_per_save - (model_steps % cfg.steps_per_save),
        cfg.steps_per_checkpoint - (model_steps % cfg.steps_per_checkpoint),
    )
    if not cross_reanalyze:
        c = min(c, cfg.steps_before_reanalyze - (model_steps + 1))
    if target_steps is not None:
        c = min(c, target_steps - model_steps)
    return max(c, 1)


def pretrain(directory, eng, net_cfg, cfg, bundle: dict, opt, train_step, rng, dev, world=None) -> int:
    """The learner's pre-training phase (learn/src/main.rs:139-171): append
    ``cfg.initial_random_targets`` random-game targets to
    ``targets-initial.txt`` and take up to ``cfg.pre_training_steps`` steps
    on them without UBE.  Returns ``(steps, pairs)``: the steps taken and,
    for hash nets, the device ``(indices, fresh)`` pair of each step.
    The caller logs the pairs and saves the step checkpoint, each driver in
    its own order.  With ``world`` every rank makes the same targets and
    batches and trains on its rows; rank 0 alone appends."""
    log.info("pre-training on %d random targets", cfg.initial_random_targets)
    targets = random_pretraining_targets(eng, cfg.initial_random_targets, rng, device=dev)
    if world is None or world.coordinator:
        co.append_lines(directory, co.TARGETS_INITIAL, [t.to_line() for t in targets])
    rng.shuffle(targets)
    pairs, steps = [], 0
    for i in range(cfg.pre_training_steps):
        chunk = targets[i * cfg.batch_size : (i + 1) * cfg.batch_size]
        if len(chunk) < cfg.batch_size:
            break
        batch = make_batch_native(eng, "".join(t.to_line() + "\n" for t in chunk), rng, device=dev)
        if world is not None:
            batch = world.rows(batch)
        if net_cfg.novelty in HASHED:
            pairs.append(hash_indices_fresh(net_cfg, bundle, batch.planes, world))
        m = train_step(bundle, opt, batch, train_ube=False)
        if i % 100 == 0:
            log.info("pretrain %d: %s", i, {k: float(v) for k, v in m.items()})
        steps += 1
    return steps, pairs


def main(argv=None) -> dict:
    """Run the learner; returns the main loop's counts and host times:
    ``steps``, ``seconds`` (wall time of the loop, device included),
    ``assemble_seconds`` (draining the buffers and building the batches)
    and ``rnd_refreshes``, the ``(model step, rnd_min, rnd_max)`` of each
    normalization refresh (RND nets; empty otherwise)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--directory", required=True)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--restart-targets", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-steps", type=int, default=None, help="for tests")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--pretrain-targets", type=int, default=None)
    parser.add_argument("--pretrain-steps", type=int, default=None)
    parser.add_argument("--no-wait", action="store_true", help="for tests")
    parser.add_argument("--steps-per-checkpoint", type=int, default=None,
                        help="immutable checkpoint cadence (default 50000, learn/src/main.rs:45)")
    parser.add_argument("--chunk-steps", type=int, default=None,
                        help="optimizer steps per chunk (default 20; 1 with --no-wait). Chunks "
                        "never cross a checkpoint boundary.")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="data-parallel training over N ranks, one per card of --device's type (N gloo "
                        "ranks on the CPU): the target batch split over the ranks, the bundle and optimizer "
                        "state whole on each, gradients summed over the ranks (the analog of the "
                        "reference's per-GPU actor fleet, SURVEY.md §2.5)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of chunks 2-4 to DIR")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = LearnConfig(
        batch_size=args.batch_size or LearnConfig.batch_size,
        initial_random_targets=args.pretrain_targets or LearnConfig.initial_random_targets,
        pre_training_steps=(
            args.pretrain_steps if args.pretrain_steps is not None else LearnConfig.pre_training_steps
        ),
        steps_per_checkpoint=args.steps_per_checkpoint or LearnConfig.steps_per_checkpoint,
    )
    world = pm.driver_world(parser, args.devices, cfg.batch_size, log, "--batch-size", args.device)
    if world.launch:
        return pm.launch(main, argv, world, args.device)[0]
    dev = world.device
    # Under a process group every rank runs this loop in lockstep: rank 0
    # owns every file write and broadcasts its target-file reads, so the
    # ranks' buffers, batches and parameters stay identical.
    multi = multihost if world.active else None
    coord = world.coordinator
    if multi:
        log.info("multihost: rank %d/%d on %s", world.rank, world.size, dev)
        args.seed = multi.broadcast_scalar(args.seed % 2**31)  # rank 0's seed: identical weights and batches
    net_cfg = NET_PRESETS[args.net]
    if net_cfg.novelty == "ensemble":
        # As in the reference, whose learn binary never trains the heads
        # either (eee/src/ensemble.rs:320-339): the variance across heads
        # at their initialisation is a constant, meaningless novelty.
        log.warning("novelty='ensemble': the ensemble heads are NOT trained by this driver "
                    "(the reference trains them only in its eee ensemble experiment)")
    eng = engine(net_cfg.n, half_komi=net_cfg.half_komi)
    rng = np.random.default_rng(args.seed)
    chunk_steps = args.chunk_steps or (1 if args.no_wait else 20)
    train_step = make_train_step(net_cfg, world)
    train_chunk = make_train_step_chunk(net_cfg, world)

    def batch_of(lines, splits=None):
        """This rank's rows of the batch (of each batch of a chunk)."""
        batch = make_batch_native(eng, "\n".join(lines) + "\n", rng, splits=splits, device=dev)
        return world.rows(batch, dim=0 if splits is None else 1)

    # Hash nets publish weights-only latest checkpoints plus the log of
    # newly set bits, computed against the bitset before each step (the
    # hash constants never train, so they are the train step's own bits).
    hash_logged = net_cfg.novelty in HASHED

    def fresh_pair(planes, dim: int):
        """The global batch's (indices, fresh) pair; ``dim`` is the batch dim."""
        if not hash_logged:
            return None
        return hash_indices_fresh(net_cfg, bundle, planes, world, dim)

    bundle = new_agent(net_cfg, seed=args.seed, device=dev)
    bundle, steps = ckpt.resume_with_hash_log(args.directory, bundle, log, reconcile=hash_logged and coord)
    # Every rank has resumed before rank 0 writes the first checkpoint.
    if multi and multi.broadcast_scalar(steps) != steps:
        raise RuntimeError(f"rank {world.rank} resumed at step {steps}, rank 0 elsewhere")
    opt = make_optimizer(bundle, cfg.learning_rate)
    if steps == 0 and coord:
        ckpt.save_checkpoint(args.directory, "model_0000000.ckpt", bundle)

    boot_idx: list = []
    if args.restart_targets:
        with open(args.restart_targets, encoding="utf-8") as f:
            lines = valid_target_lines(net_cfg.n, f.read().splitlines())
        rng.shuffle(lines)
        for i in range(0, len(lines) - cfg.batch_size + 1, cfg.batch_size):
            batch = batch_of(lines[i : i + cfg.batch_size])
            boot_idx.append(fresh_pair(batch.planes, 0))
            train_step(bundle, opt, batch, train_ube=False)
            steps += 1
        if coord:
            ckpt.save_checkpoint(args.directory, f"model_{steps:07d}.ckpt", bundle)
    elif steps == 0 and cfg.pre_training_steps > 0:
        n, boot_idx = pretrain(args.directory, eng, net_cfg, cfg, bundle, opt, train_step, rng, dev, world)
        steps += n
        if coord:
            ckpt.save_checkpoint(args.directory, f"model_{steps:07d}.ckpt", bundle)

    if coord:
        if hash_logged and boot_idx:
            ckpt.append_hash_indices(args.directory, ckpt.fresh_indices(
                torch.cat([i for i, _ in boot_idx]), torch.cat([f for _, f in boot_idx])
            ))
        ckpt.save_checkpoint(args.directory, "model_latest.ckpt", ckpt.strip_hash_bits(bundle))

    rnd_refs, rnd_refreshes = None, []

    def refresh_rnd(model_steps: int) -> None:
        rnd_update_normalization(net_cfg, bundle, *rnd_refs)
        lo, hi = float(bundle["rnd_min"]), float(bundle["rnd_max"])
        rnd_refreshes.append((model_steps, lo, hi))
        log.info("RND normalization at step %d: min=%.4f max=%.4f", model_steps, lo, hi)

    if net_cfg.novelty == "rnd":
        rnd_refs = tuple(random_plane_batch(eng, torch.Generator(device=dev).manual_seed(args.seed ^ salt), ply, 64)
                         for salt, ply in ((0xE, 8), (0xF, 60)))
        refresh_rnd(steps)

    sp_buffer = TargetBuffer(rng)
    re_buffer = TargetBuffer(rng)
    sp_tail = co.Tailer(args.directory, co.TARGETS_SELFPLAY)
    re_tail = co.Tailer(args.directory, co.TARGETS_REANALYZE)
    last_read = 0.0

    def tail_lines(tail):
        """New lines of a target file: rank 0 reads, every rank gets them."""
        lines = tail.read_new_lines() if coord else None
        return multi.broadcast_lines(lines) if multi else lines
    pending_metrics: list = []
    saver = ckpt.AsyncSaver()
    last_flush = [0.0]

    def flush_metrics(item):
        """Read one chunk's metrics and fresh bits; log and (rank 0) record per step."""
        first_step, c, metrics, pair = item
        keys = sorted(metrics)
        host = torch.stack([metrics[k] for k in keys]).cpu().numpy()
        if pair is not None and coord:
            ckpt.append_hash_indices(args.directory, ckpt.fresh_indices(*pair))
        jsonl = []
        for i in range(c):
            m = {k: float(host[j, i]) for j, k in enumerate(keys)}
            log.info("step %d: loss=%.4f policy=%.4f value=%.4f ube=%.4f", first_step + i,
                     m["loss"], m["loss_policy"], m["loss_value"], m["loss_ube"])
            jsonl.append(json.dumps({"step": first_step + i, **m}))
        now = time.time()
        if last_flush[0]:
            log.info("chunk of %d flushed: %.1f steps/s end-to-end", c, c / max(now - last_flush[0], 1e-9))
        last_flush[0] = now
        if coord:
            co.append_lines(args.directory, "metrics.jsonl", jsonl)

    trace = StepTrace(args.profile if coord else None, log, device=dev)

    def finish(loop_steps: int, t_loop: float, assemble_s: float) -> dict:
        trace.stop()
        for item in pending_metrics:
            flush_metrics(item)
        # Always leave a final latest for downstream consumers.
        if coord:
            saver.submit(args.directory, "model_latest.ckpt", ckpt.strip_hash_bits(bundle))
        saver.drain()
        seconds = time.perf_counter() - t_loop
        log.info("learn loop: %d steps in %.3f s, batch assembly %.3f s", loop_steps, seconds, assemble_s)
        return {"steps": loop_steps, "seconds": seconds, "assemble_seconds": assemble_s,
                "rnd_refreshes": rnd_refreshes}

    target_steps = None if args.max_steps is None else steps + args.max_steps
    model_steps = steps
    t_loop, assemble_s = time.perf_counter(), 0.0
    while target_steps is None or model_steps < target_steps:
        trace.step()
        first = model_steps + 1
        using_reanalyze = args.restart_targets is not None or first >= cfg.steps_before_reanalyze
        c = chunk_len(model_steps, chunk_steps, cfg, cross_reanalyze=using_reanalyze,
                      target_steps=target_steps)

        while True:
            want_read = time.time() - last_read >= (0.0 if args.no_wait else cfg.min_seconds_between_reads)
            if multi:
                # A clock-gated decision differs between ranks: follow rank
                # 0, so every rank makes the same broadcast reads.
                want_read = bool(multi.broadcast_scalar(want_read))
            if want_read:
                sp_buffer.extend(valid_target_lines(net_cfg.n, tail_lines(sp_tail)), cfg.selfplay_forced_uses, first)
                if using_reanalyze:
                    re_buffer.extend(valid_target_lines(net_cfg.n, tail_lines(re_tail)),
                                     cfg.reanalyze_forced_uses, first)
                last_read = time.time()
                if coord:
                    co.write_buffer_lengths(args.directory, len(sp_buffer), len(re_buffer))

            if args.no_wait:
                # Tests: fit the chunk to the available full batches.
                c = min(c, max(1, len(sp_buffer) // cfg.batch_size))
            # Worst case every drained entry is on its last forced use: gate
            # on the chunk's full consumption per stream.
            need_sp = c * (cfg.batch_size // 2 if using_reanalyze else cfg.batch_size)
            need_re = c * (cfg.batch_size // 2)
            min_sp = c * cfg.batch_size if args.no_wait else max(cfg.min_selfplay_buffer, need_sp)
            min_re = c * cfg.batch_size if args.no_wait else max(cfg.min_reanalyze_buffer, need_re)
            enough_sp = len(sp_buffer) >= min_sp
            enough_re = not using_reanalyze or len(re_buffer) >= min_re
            if enough_sp and enough_re:
                break
            if args.no_wait:
                if enough_sp:  # tests: degrade to selfplay-only batches
                    using_reanalyze = False
                    break
                return finish(model_steps - steps, t_loop, assemble_s)
            log.info("not enough targets (sp=%d re=%d), sleeping %.0fs",
                     len(sp_buffer), len(re_buffer), cfg.sleep_when_starved)
            time.sleep(cfg.sleep_when_starved)

        t_a = time.perf_counter()
        drained: list = []
        for _ in range(c):
            if using_reanalyze:
                half = cfg.batch_size // 2
                drained += sp_buffer.drain_batch(half) + re_buffer.drain_batch(half)
            else:
                drained += sp_buffer.drain_batch(cfg.batch_size)
        # One parse and one transfer for the whole chunk.
        batches = batch_of(drained, splits=c)
        t_b = time.perf_counter()
        assemble_s += t_b - t_a
        pair = fresh_pair(batches.planes, 1)
        metrics = train_chunk(bundle, opt, batches, train_ube=True)
        t_c = time.perf_counter()
        first_step = model_steps + 1
        model_steps += c
        pending_metrics.append((first_step, c, metrics, pair))
        if len(pending_metrics) > 1:
            flush_metrics(pending_metrics.pop(0))
        if os.environ.get("TAKZERO_LEARN_TIMING"):
            log.info("chunk timing: assemble=%.3fs stack+dispatch=%.3fs flush=%.3fs (c=%d)",
                     t_b - t_a, t_c - t_b, time.perf_counter() - t_c, c)
        if rnd_refs is not None and model_steps % 100 == 0:
            refresh_rnd(model_steps)
        if coord and model_steps % cfg.steps_per_save == 0:
            saver.submit(args.directory, "model_latest.ckpt", ckpt.strip_hash_bits(bundle))
        if coord and model_steps % cfg.steps_per_checkpoint == 0:
            saver.submit(args.directory, f"model_{model_steps:07d}.ckpt", bundle)
    return finish(model_steps - steps, t_loop, assemble_s)


if __name__ == "__main__":
    main()
