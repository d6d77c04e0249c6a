"""Smoke test of the PyTorch/CUDA port (``takzero_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--kernels-only]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
It imports nothing of JAX or of ``takzero_tpu``.  Launches are read from
the port's launch counters (``takzero_torch/ops/_build.py``); a phase
that searches on the card expects :func:`per_simulation` of its net a
simulation: kernel A, the descent and the backup once, kernel B once on
a SimHash net, the convolution kernel 2 blocks + 2 in bf16.  Phases, in
order:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. the build of every kernel from ``takzero_torch/csrc`` (seconds);
3. kernel A (exact unsorted top-k) against ``topk_plain``: at the main
   path's f32[128, 9036], k=256, on masked logits of random 6x6 positions
   (timed: what the search's expansion gives the kernel), the same with
   special rows mixed in (all ties, +-inf, unmasked), then on adversarial
   rows at A=9036 and A=24843 with k=1, 256 and A: the threshold at the
   mask value with thousands of ties, a threshold bin of many distinct
   keys, +-inf, mixed +-0.0, all-equal rows.  The kernel's device time on
   the special and the adversarial rows (A=9036, k=256) is logged too; a
   launch takes as long as its slowest row.  Values (bit for bit) and
   indices must match exactly;
4. kernel B (SimHash pack) against ``simhash_plain``: the main path's
   planes at 26 and 32 bits (timed), 1 bit, B=1, and B and In that are
   not multiples of the kernel's tiles.  Every bit whose float64 dot
   satisfies |dot| > 1e-4 must match, and two launches must give
   identical words;
4b. the search's descent, settle, expansion and backup kernels
   (``ops/tree.py``) at the selfplay cells' shapes, [128 lanes, C=256] at
   6x6 and [128, C=128] at 5x5, on the tree of a Gumbel search (simple
   evaluator, k=64, budget 384, fresh openings): the descent with a forced
   slot under ``skip_root`` (as the search's simulations run it) and
   without, the settle of the forced descent's lanes, their expansion
   (the mask and store kernels around kernel A, on random bf16 logits)
   and the backup of its paths, every output and tree array bit for bit
   equal to the batched loops', ``settle``'s and ``apply_eval``'s; timed
   (device time, call time, the batched path's call time, and the
   settle's and ``apply_eval``'s device time too; the bytes bound: a level
   reads a node's row of 8 arrays in the descent, of 4 in the backup; the
   settle reads a state and a path and writes a state a lane; the mask
   reads the logits and writes kernel A's float32 input; the store reads
   kernel A's children and writes 9 child rows and a state a lane);
4c. the evaluator's convolution kernel (``ops/conv.py``) at the selfplay
   cells' tower layer, [128, 6x6, 256 -> 256] and [128, 5x5, 256 -> 256]
   with the residual: the float32 sum within 1e-5 of sum |x*w| of float64,
   the bf16 output within one rounding of the plain version; timed (device
   time, call time, bound at 989 TFLOP/s, the plain version's call time,
   and the present path's device time: cuDNN TF32 on float32 copies, the
   residual, relu and cast); then the whole bf16 evaluator at net6's and
   net5's widths, 128 rows, a launch at a time on the tiles the main path
   takes: the stem on the float32 planes and each tower layer within one
   rounding of the plain version, the head's policy, value and UBE
   channels within 1e-5 of sum |x*w| of float64; ``apply_folded``'s
   outputs that chain's bit for bit in 2 blocks + 2 launches; device time
   through the kernel and through the cuDNN path;
3b. kernel A on rows too wide for shared memory (after phase 4, so that
   ``--kernels-only`` still times earlier designs): 8x8's f32[128, 65216]
   on masked logits of random 8x8 positions and on the adversarial rows,
   with k=1, 256 and A, values bit for bit and indices exactly; device
   time, call time, bound, plain time and ``torch.topk``'s at k=256;
3c. the Gumbel search at 8x8: the small net of
   ``tests/test_torch_bigboards.py`` on the card against the CPU (trees
   equal, floats within 1e-4), then one search at 16x256 bf16 with SimHash
   over 2^32 bits (128 games, k=8, budget 24, C=256): actions legal, the
   root-visit invariant, every kernel's launches those of budget+1
   simulations;
5. a small reference check: the 3x3 move program (dummy evaluator), the
   small network in float32 and in bf16 on the card against the same on
   the CPU, and one bf16 convolution at the flagship width against
   float64, through the convolution kernel and through cuDNN's TF32 (the
   float32 accumulation);
6. the main path: ``takzero_torch.bench`` at the flagship configuration
   (6x6, 16x256 bf16 net, SimHash 2^26, batch 128, k=64, budget 768,
   C=256, tree reuse), one warm-up move and one timed move (cut from the
   bench's two to keep the smoke inside its time).  The launch counters
   of kernels A and B and of the descent and backup kernels are set to 0
   before and must read (budget+1) per move after (a descent and a backup
   a simulation), the convolution kernel's 34 (budget+1) (2 blocks + 2 an
   evaluation); chosen actions must be legal and tree values finite;
7. the learner, small reference: two ``tiny3`` train steps (``train_ube``
   False, then True) on the card against the same steps on the CPU, from
   the same weights and batches, in float32 and in bf16: metrics, BN
   statistics and parameters within the stated tolerances, the SimHash
   seen-set exactly equal;
8. the learner's main path at full width: ``takzero_torch.drivers.learn``
   with ``--net net6_simhash --batch-size 128`` (16x256 bf16, SimHash over
   2^32 bits) in a temporary directory: pre-training on 1,280 random-game
   targets for 10 steps, then 10 steps of one batch and 20 steps in
   chunks of up to 4 from a ``targets-selfplay.txt`` that the phase writes
   with ``train.data.random_pretraining_targets``, each run resuming from
   the last.  Both counters are set to 0 before and read after: kernel B
   must have launched exactly as often as the driver's calls imply (two
   per pre-training step, one per train step and one per chunk) and
   kernel A never.  Every loss in ``metrics.jsonl`` must be finite, the
   last step checkpoint must load, and its seen-set must equal the one
   rebuilt from ``hash_log.bin``.  Kernel B is checked against its plain
   version on the learner's own planes (128 and 512 rows).  The phase
   line gives steps/s end to end, the device time of one train step
   (CUDA events around 10 steps on one resident batch, after warm-up), the
   share of the loop's time spent assembling batches on the host, and peak
   device memory;
9. the actor-learner loop: kernel A against ``topk_plain`` at the loop's
   f32[128, 944] with k=1, 128 and 944 on masked 4x4 logits and on the
   adversarial rows, kernel B against ``simhash_plain`` on 4x4 planes,
   both timed; then the three drivers at ``net4_simhash`` full width
   (16x256 bf16, SimHash over 2^32 bits) in one temporary directory, the
   search cut to batch 128, k=8, budget 24: the learner pre-trains (1,280
   random-game targets, 10 steps) and publishes ``model_latest.ckpt``; the
   selfplay driver plays until 64 games have finished; the learner takes
   10 steps on its targets; the selfplay driver plays 2 more moves (its
   poller must reload once, and its seen-set must equal ``bitset_set`` of
   all of ``hash_log.bin``); the reanalyze driver takes 2 steps at batch
   128 on the exploded replays; one train step runs on a batch of
   ``targets-reanalyze.txt``.  It fails on a target line the port's parser
   rejects, a policy that does not list exactly the legal actions of its
   TPS, a replay that does not replay to its recorded result, a kernel
   count (A, B, the descent and the backup kernels) other than (budget+1)
   per selfplay move and per reanalyze step,
   or a non-finite value or loss.  The phase line gives selfplay moves/s,
   targets/s and the host half's share of the move time, reanalyze
   targets/s and the share of replay explosion, the learner's steps/s on
   selfplay targets, peak device memory and the phase's seconds;
10. the serve path (``takzero_torch.drivers.{tei,analysis,evaluation,
   puzzle}`` and ``takzero_torch.serve_bench``), every net 16x256 bf16
   with SimHash over 2^32 bits: (a) one TEI chunk at net6_simhash from a
   random 6x6 midgame with both kernels' inputs recorded: kernel A must
   equal ``topk_plain`` at the serve chunk's f32[127, 9036], k=256 and the
   plain simulate's f32[1, 9036], kernel B ``simhash_plain`` on the
   [127, 1296] and [1, 1296] planes under phase 4's rule, both timed at the
   serve shape (A beside ``torch.topk``), and one more chunk under the
   profiler (device kernels and busy time, host time per wavefront
   phase); (b) ``TeiEngine.handle`` on
   ``tei``, ``isready``, ``position startpos``, ``go nodes 1024``, the
   bestmove played, ``go nodes 1024``, the midgame TPS, ``go movetime
   2000``, ``quit``: every bestmove legal, every ``info`` line parsed, the
   tree reused (the descended root keeps the child's visits), kernels A
   and B launched exactly twice per chunk, the descent and backup kernels
   once (the plain simulate's; the serve chunk has its own loops); (c) ``serve_bench`` with its defaults
   (nodes/s, seconds per chunk, peak device memory) beside TEI's own nps;
   (d) one analysis chunk on a fresh tree: 128 root visits, one table row
   per valid root child, kernel A 128 launches and B 2, the descent
   kernel 128 and the backup kernel 255; (e) the evaluation
   driver with ``--pair`` at net4_simhash on two checkpoints of
   ``new_agent`` seeds 1 and 2 (32 games, k=4, budget 8, 25 moves a side:
   depth cut): both log lines parse as the Elo tooling parses them, W+L+D
   <= games, kernels A and B and the tree kernels (budget+1) launches per
   half-move; (f) the puzzle
   driver at net6_simhash on the repository's ``examples/puzzles_6x6.db``
   (238 puzzles, every category: tinue at depths 3/5/7/9, avoidance at
   2/4/6; 7 batches of up to 64; k=8, budget 24): every puzzle attempted,
   (budget+1) launches of A, B and the tree kernels per batch, solved and proven reported per depth
   (random weights: not gated);
11. the co-scheduled driver (``takzero_torch.drivers.coscheduled``) at
   net4_simhash full width (16x256 bf16, SimHash over 2^32 bits, C=128)
   with ``--reanalyze``: batch 128, k=8, budget 24, learner batch 128,
   reanalyze batch 128 from 2,048 positions, the 64+64 mix from step 12,
   pre-training 10 steps on 1,280 targets, 52 moves (phase 9's cuts; 4x4
   so that whole games end inside a smoke).  It fails on fewer than 2
   reanalyze batches or mixed steps, fewer than 128 finished games, launch
   counts other than (budget+1) per move and per reanalyze batch (A) plus
   2 per train step (B), in all and (A) in each move as read between two
   moves' draws, a target line or replay that phase 9's checks
   reject, a non-finite loss, a step checkpoint equal to
   ``model_0000000.ckpt``, a ``model_latest.ckpt`` holding the seen-set,
   or a seen-set that ``bitset_set`` of ``hash_log.bin`` does not rebuild;
   it logs moves/s, train steps/s, reanalyze targets/s, peak memory and
   seconds;
12. ``takzero_torch.tiny_run`` at its defaults cut to 1 iteration and 8
   evaluation games: the summary parses, games = 16, the final loss is
   finite, launches as the loop implies, in all and in the one iteration
   read from the counters around it (no Elo gate);
13. the novelty variants: (a) ``tiny3_rnd``, ``tiny4`` (LCG hash over
   2^24 bits), net5 with its core cut to 16x2 and its MLP RND at full
   width (800-1024-1024-512), and a 16x2 ensemble net of 16 heads, each
   on the card against the CPU from the same weights in float32 and bf16:
   the input planes and LCG hash indices bit for bit, ``net_evaluate``'s
   outputs, two train steps' metrics (``loss_rnd`` included), the RND
   bounds after a refresh and the seen-sets, and the RND target unchanged
   bit for bit; (b) phase
   9's loop at ``net4_rnd`` (16x256 bf16, two 32x4 RND towers), same cuts:
   every refresh of the learner's bounds finite with min < max, the actor's
   poller holding the learner's last bounds, ``model_latest.ckpt`` holding
   the RND keys, ``loss_rnd`` finite, no ``hash_log.bin``, kernel B never
   launched; (c) ``net4_lcghash`` (LCG hash over 2^32 bits, a 512 MiB
   seen-set): pre-training, 4 selfplay moves, 4 learner steps, 2 more
   moves: the hash log holds distinct indices that rebuild the learner's
   seen-set, the actor's seen-set equals it after its poll, kernel B never
   launched; (d) kernel A against ``topk_plain`` at net5's 5x5
   f32[128, 3075] (k=1, 128 and A; timed at k=128 beside ``torch.topk``),
   then ``net4_ensemble`` and ``net5`` at full width: pre-training (the
   ensemble learner warns that its heads stay untrained), one selfplay
   move each with kernel A (budget+1) launches and B none, the variance in
   [0, 4], and two net5 learner steps;
14. the EEE experiments and the visualizers, at the JAX defaults' widths
   with steps and plies cut, on the replays and targets that phases 9 and
   11 wrote: (a) ``eee.generalization`` at 4x4, batch 256, SimHash over
   2^26 bits for 20 steps and the LCG hash for 3 (``current`` 4.0 at step
   0, ``after`` exactly 0.0 at every step, values in [0, 4]; kernel B 8
   launches a SimHash step, none under the LCG hash, its words on one
   step's [256, 448] planes equal ``simhash_plain``'s under phase 4's
   rule); (b) ``eee.rnd`` with two 32x4 bf16 towers, batch 256, 20 steps
   (finite, ``after <= current`` on the last step, the reference's CSV
   header); (c) a 16x2 ensemble step on the card against the CPU (float32
   1e-4, bf16 5e-2), then ``eee.ensemble`` at 16x256 bf16 with 16 heads,
   batch 128, 5 steps (losses finite, ``loss_ensemble >= 0``, variances in
   [0, 4]); each logs whether ``early`` and ``late`` came from the replay
   pools or fell back to random games; (d) ``drivers/eee.py seen-ratio``
   at net6_simhash, batch 65,536, plies 0-15, on the step checkpoint of a
   short learner pre-training (ratios in [0, 1], kernel B once a ply, its
   words on the last ply's [65536, 1296] planes equal ``simhash_plain``'s
   under phase 4's rule, seconds per ply, peak memory), and at batch 512
   the card's ratios equal to the CPU's from the same draws; (e)
   ``drivers/graph.py`` and ``drivers/visualize_replay_buffer.py`` on the
   two replay files; (f) ``drivers/visualize_search.py``: a small RND net's
   tree on the card against the CPU (trees equal, floats within 1e-4), then
   net4_rnd at full width, 200 visits, betas 0 and 1 (each SVG written,
   root visits = visits, kernel A once a simulation, its inputs equal
   ``topk_plain``'s at f32[1, 944] with k = 1, 64 and 944, timed at k=64
   beside ``torch.topk``);
15. the rules oracle and the offline tools (``takzero_torch/tak/oracle.py``
   and ``takzero_torch/tools``): (a) the build of the port's C++ copy
   (``ops/_cpp_build.py``: the oracle library and ``tak_mcts_bench``,
   seconds) and 2 random 6x6 games of the port's engine on the card against
   the oracle, every legal mask, state and result equal; (b)
   ``tools.make_puzzles`` at 6x6 (8 games, batch 64, budget 256, C=128,
   no deep pass, 20,000 verifier nodes, target 2, 20 s): kernel A budget+1
   launches a solve and B none, the last solve's 257 inputs equal
   ``topk_plain``'s at k = 1, 128 and A, A timed at f32[64, 9036], k=128
   beside ``torch.topk``, every written row re-checked on the oracle
   (legal solution, tinue depth or avoidance depth), seconds per solve,
   candidates and discards; (c) ``tools.elo_curve`` over two numbered
   net4_simhash checkpoints (1 round, 4 games, budget 8, k=4; the
   evaluation subprocess on the card), the CSV and a finite curve, and the
   same rows from ``--skip-matches``; (d) ``tools.reuse_ab`` at
   net6_simhash (64 games a direction, budget 24, k=8, 4 moves a side): A
   and B budget+1 launches a half-move, the last half-move's inputs equal
   the plain versions' (B under phase 4's rule), B timed at [64, 1296] x
   [1296, 32], seconds per half-move; (e) ``tools.anchor --quick``: the
   C++ bench's sims/s on one core and the float32 16x256 network's
   positions/s on the card; (f) ``tools.openings`` at 4x4, depth 3: the
   count, every book parsing back to its TPS;
16. multi-device (two gloo ranks share the card: the collectives' cost,
   not scaling): (a) every collective the port uses under NCCL at world 1
   and under gloo at world 2, rank 0's values on every rank; (b) the
   learner through ``drivers.multihost`` (two ranks on card 0) at
   net6_simhash, global batch 128, 10 pre-training and 10 loop steps,
   beside ``--devices 1`` under NCCL: the first step's loss within 1e-3,
   both ranks' weights bit-identical (a digest), the seen-set rebuilt from
   ``hash_log.bin``, kernel B's launches read from each rank's counters
   and held to ``simhash_plain`` on a rank's rows; (c) selfplay through
   the launcher at net4_simhash, 128 games (64 a rank), k=8, budget 24,
   until 16 games end, in bf16 (the preset) and at the same widths in
   float32: A and B budget + 1 launches a move a rank, held to their plain
   versions at f32[64, 944] and [64, 448] on recorded inputs, each replay
   line once, ``replays.txt`` and ``targets-selfplay.txt`` byte for byte
   equal to world 1's in both; the ranks evaluate their rows at the global
   batch's shape (``World.at_global_shape``, since cuDNN picks a bf16
   convolution's order of summation by the batch's shape), and the padded
   bf16 evaluator must give the whole batch's outputs bit for bit; (d)
   reanalyze (2 steps) in bf16 and in float32, byte for byte, and in
   float32 the pit fighter (32 games, equal W/L/D), one puzzle batch
   (equal results) and 3 co-scheduled moves (files byte for byte) on two
   ranks against world 1; (e) ``tools.multihost_scaling --configs 1x1,2x1
   --backend gloo``;
17. the last JAX modules: (a) the C++ target loader
   (``data/native_loader.py``) on phase 9's target and replay files
   against the plain parse (``Target.from_line``, ``Replay.states``):
   states, values, policies and positions equal, both timed; (b) a JAX
   run's checkpoint (``tests/data/jax_model_4x4.ckpt``, flax msgpack)
   loaded and evaluated on the card to JAX's outputs in
   ``jax_model_4x4_outputs.npz`` within 1e-4 (float32), kernel B once;
   (c) ``search/noise.py`` ``apply_dirichlet`` and ``search/policy.py``
   ``uct_scores`` on a searched 6x6 tree (128 games, C=256): the noised
   root sums to 1, UCT is finite on every valid unpruned slot, and both
   equal the CPU's on the same tree and draws within 1e-6; (d)
   ``tools.pool_cliff --stub --pools 776,3104 --sims 32`` and
   ``tools.phase_cliff`` at the same pools: ms a simulation at each M and
   its growth a pool doubling, kernel A once a simulation (read from the
   counters);
18. the search's choice of top-k (``search/core.py`` ``make_topk``:
   ``pallas``, kernel A; ``lax`` and ``grouped``, the library top-k with
   ``lax.top_k``'s order and JAX's two-stage grouped one; ``exact_ref``,
   ``topk_plain``), each chosen through ``topk=``, never the environment
   (the script refuses to start with ``TAKZERO_TOPK`` set): (a) each impl
   at phase 3's f32[128, 9036], k=256, on its masked logits and special
   rows: the values bit for bit and the index sets of rows without a tie
   at the k-th value equal ``topk_plain``'s, ``lax`` and ``grouped`` in
   the stable sort's order on tied rows (and whether a bare
   ``torch.topk`` is, reported), each timed by the CUDA-graph method; (b)
   one float32 selfplay move at the flagship's widths (16x256, SimHash
   2^26, 128 games, k=64, C=256, tree reuse; budget cut to 384, the least
   at k=64; the random policy head scaled by 1/20, see
   ``run_topk_moves``) under ``pallas``, ``lax`` and ``grouped`` from the
   same weights, openings and per-action noise: on every game without a
   selection tie the actions and per-action root visits equal and root
   values within 1e-5 (the tied games counted), kernel A budget+1
   launches under ``pallas`` and none otherwise, B budget+1 under each;
   wall seconds and CUDA-event ms per move, and a ``topk_ab`` line;
19. a ``kernels`` JSON line: each kernel with what it replaces, its
   launches on the move program (``launches``), on the learner
   (``learner_launches``), on the selfplay driver and on reanalyze
   (``selfplay_driver_launches``, ``reanalyze_launches``), on the serve
   path (``tei_launches``, ``analysis_launches``, ``evaluation_launches``,
   ``puzzle_launches``), its error against the plain version, its device
   time (``ms``), its call time (``call_ms``), the plain version's and the
   library call's device times, its bound, the same at the loop's 4x4
   shape (``at_4x4``), and at the serve chunk's shape (``serve_ms``,
   ``serve_call_ms``, ``serve_bound_ms``, ``serve_plain_ms``,
   ``serve_library_ms``); kernel A at 8x8 (``at_8x8``), and each kernel's
   launches on the 8x8 search, the co-scheduled driver and tiny_run
   (``search_8x8_launches``, ``coscheduled_launches``,
   ``tiny_run_launches``; per move of the co-scheduled driver and per
   iteration of tiny_run, each read from the counters in this run), on
   the novelty phases (``rnd_loop_selfplay_driver_launches``,
   ``rnd_loop_reanalyze_launches``, ``lcghash_launches_per_move``,
   ``ensemble_launches_per_move``, ``net5_launches_per_move``), kernel A
   at 5x5 (``at_5x5``), and on phase 14 (``eee_generalization_launches_per_step``,
   ``eee_generalization_lcghash_launches``, ``seen_ratio_launches_per_ply``,
   ``visualize_search_launches_per_simulation``) with kernel A at
   f32[1, 944] (``at_1x944``) and kernel B at [65536, 1296] x [1296, 32]
   (``at_seen_ratio``) and [256, 448] x [448, 26] (``at_eee_generalization``),
   and on phase 15 (``prover_launches_per_solve``,
   ``reuse_ab_launches_per_half_move``) with kernel A at the prover's
   f32[64, 9036], k=128 (``at_prover``) and kernel B at reuse_ab's
   [64, 1296] x [1296, 32] (``at_reuse_ab``), and on phase 16: both at
   selfplay's rank shapes (``at_rank_selfplay``), the launches of each
   rank (``launches_per_rank``) and the learner's gradient all-reduce
   (``learner_allreduce_ms``), on phase 17 (``jax_checkpoint_launches``,
   ``pool_tools_launches``), and on phase 18b
   (``topk_ab_launches_per_move``) with each impl's µs per call at
   f32[128, 9036] (``topk_impls_us_per_call``); then the descent, settle,
   expansion and backup kernels (``tree_descend``, ``tree_settle``,
   ``expand_mask``, ``expand_store``, ``tree_backup``) with their launches
   on the move program, the selfplay driver, reanalyze and the serve
   path, read from the counters in this run, and phase 4b's rows at
   [128, C=256] (``at_6x6``) and [128, C=128] (``at_5x5``); last the
   convolution kernel (``conv3x3``) with its launches on the move program
   and phase 4c's rows (``at_6x6``, ``at_5x5``).

Device time per call: 50 calls of the wrapper captured in one CUDA graph,
the graph replayed 20 times between two CUDA events (the profiler's summed
kernel time if capture fails; the phase line says which).  Call time per
call: 200 back-to-back calls of the wrapper after 20 warm-up calls, between
two CUDA events, which is what the main path pays with the host in the
loop.  ``--kernels-only`` stops after phase 4c (a short call, or a checkout
of an earlier design of the kernels).

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises,
so the script exits non-zero and prints no such line; without a CUDA card
it exits with 1 at once.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from takzero_torch.ops._build import launch_counts, zero_launches

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory bandwidth,
# float32 outside the tensor cores, and TF32 and bf16 in them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12  # tensor cores, dense
BF16_FLOPS = 989e12  # tensor cores, dense
NEG = -3.0e38
# Kernels A and B: the counters the phases written before the tree and
# convolution kernels compare.
AB = ("exact_top_k_unsorted", "simhash_pack")


def float32_without_tf32() -> None:
    """The smoke's numerics: float32 matmuls and convolutions in full
    float32 (no TF32; the bf16 convolutions still take exact TF32 inside
    ``conv_precision``).  Spawned ranks set it too, so that every world
    computes alike."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of back-to-back calls, host cost included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiler_ms(fn, calls: int = 50) -> float:
    """Summed device time of the kernels of one call, from the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3


def device_ms(fn, calls: int = 50, replays: int = 20) -> tuple[float, str]:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events.  Returns (ms, method)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        torch.cuda.synchronize()
        return profiler_ms(fn), f"profiler ({type(exc).__name__}: {str(exc)[:80]})"
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms, "graph"


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def random_positions(eng, batch: int, plies: int, gen, dev):
    """Random 6x6 playout positions on the card, of random length."""
    import torch

    from takzero_torch.tak.state import where_state

    envs = eng.initial(batch, dev)
    stop = torch.randint(0, plies + 1, (batch,), generator=gen, device=dev)
    for p in range(plies):
        legal = eng.legal_mask(envs)
        any_legal = legal.any(-1, keepdim=True)
        live = (p < stop) & (eng.terminal_kind(envs) == 0) & any_legal[:, 0]
        act = torch.multinomial((legal | ~any_legal).float(), 1, generator=gen)[:, 0]
        envs = where_state(live, eng.step(envs, act), envs)
    return envs


def adversarial_rows(a: int, gen, dev):
    """f32[128, a] in eight groups of 16 rows, each hard for a radix select."""
    import torch

    x = torch.randn(128, a, generator=gen, device=dev)
    rand = lambda: torch.rand(16, a, generator=gen, device=dev)  # noqa: E731
    g = [slice(16 * i, 16 * (i + 1)) for i in range(8)]
    x[g[1]] = torch.randint(0, 4, (16, a), generator=gen, device=dev).float()  # integer ties
    x[g[2]] = torch.where(rand() < 100 / a, x[g[2]], NEG)  # threshold at NEG, thousands of ties
    x[g[3]] = torch.where(rand() < 600 / a, x[g[3]], NEG)  # more than 256 legal
    x[g[4]] = 1.0 + rand() * 2.0 ** -12  # one 11-bit bin of many distinct keys
    x[g[5]] = torch.where(rand() < 0.5, -torch.inf, x[g[5]])
    x[g[5], ::97] = torch.inf
    choice = torch.tensor([1.0, 0.0, -0.0, -1.0], device=dev)
    u = rand()
    pick = torch.where(u < 1 / 64, 0, torch.where(u < 0.5, 1, torch.where(u < 0.9, 2, 3)))
    x[g[6]] = choice[pick]  # threshold at zero, +0.0 and -0.0 mixed
    x[g[7]] = torch.where(rand() < 0.3, 1.0, NEG)  # the dummy evaluator: ties under a mask
    x[g[7]][:4] = 1.0
    return x.contiguous()


def expect_topk_equal(x, k: int, what: str) -> None:
    import torch

    from takzero_torch.ops import topk

    vals, idx = topk.exact_top_k_unsorted(x, k)
    pv, pi = topk.topk_plain(x, k)
    torch.cuda.synchronize()
    if not torch.equal(idx, pi):
        bad = (idx != pi).any(-1).nonzero()[:, 0].tolist()
        raise AssertionError(f"top-k kernel ({what}): indices differ from plain in rows {bad}")
    if not torch.equal(vals.view(torch.int32), pv.view(torch.int32)):
        bad = (vals.view(torch.int32) != pv.view(torch.int32)).any(-1).nonzero()[:, 0].tolist()
        raise AssertionError(f"top-k kernel ({what}): value bits differ from plain in rows {bad}")


def check_topk(eng, envs, gen, dev) -> dict:
    import torch

    from takzero_torch.ops import topk

    legal = eng.legal_mask(envs)
    b, a = legal.shape
    logits = torch.randn(b, a, generator=gen, device=dev)
    main_rows = torch.where(legal, logits, NEG).contiguous()  # what apply_eval gives the kernel
    x = main_rows.clone()
    x[96:112] = torch.where(legal[96:112], 1.0, NEG)  # the dummy evaluator: all ties
    x[112:116] = -torch.inf  # fewer than k finite entries
    x[112:116, 500:520] = 2.0
    x[116:120, 7] = torch.inf
    x[120:124] = 1.0  # all equal, nothing masked
    x[124:128] = logits[124:128]  # more than k candidates, nothing masked
    x = x.contiguous()
    k = 256
    expect_topk_equal(main_rows, k, "main-path rows")
    expect_topk_equal(x, k, "main-path rows with special rows")
    cases = []
    for width in (9036, 24843):
        rows = adversarial_rows(width, gen, dev)
        for kk in (1, 256, width):
            expect_topk_equal(rows, kk, f"adversarial A={width} k={kk}")
            cases.append([width, kk])
        if width == a:
            adversarial_ms = device_ms(lambda: topk.exact_top_k_unsorted(rows, k))[0]
    ms, how = device_ms(lambda: topk.exact_top_k_unsorted(main_rows, k))
    plain, plain_how = device_ms(lambda: topk.topk_plain(main_rows, k))
    lib, lib_how = device_ms(lambda: torch.topk(main_rows, k, sorted=False))
    out = dict(
        shape=[b, a], k=k, rows_fewer_than_k_legal=int((legal.sum(-1) < k).sum()),
        adversarial_cases_a_k=cases, adversarial_rows_kernel_ms=adversarial_ms,
        special_rows_kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(x, k))[0], max_abs_err=0.0,
        kernel_ms=ms, call_ms=call_ms(lambda: topk.exact_top_k_unsorted(main_rows, k)),
        plain_ms=plain, library_ms=lib, timing={"kernel": how, "plain": plain_how, "library": lib_how},
    )
    out["bound_ms"], out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    log({"phase": "kernel A exact_top_k_unsorted", **out})
    out["rows"] = {"main-path rows": main_rows, "special rows": x}  # phase 18a's inputs
    return out


def expect_simhash_equal(x, m, what: str) -> float:
    """Kernel vs plain on every bit whose float64 dot is clear of 0, and
    two launches identical; returns the largest difference of sure bits."""
    import torch

    from takzero_torch.ops import simhash

    got = simhash.simhash_pack(x, m)
    again = simhash.simhash_pack(x, m)
    want = simhash.simhash_plain(x, m)
    bits = m.shape[1]
    dots = x.double() @ m.double()
    sure = ((dots.abs() > 1e-4).long() << torch.arange(bits, device=x.device)).sum(-1)
    diff = int(((got & sure) != (want & sure)).sum())
    if diff:
        raise AssertionError(f"SimHash kernel ({what}): {diff} words differ from plain")
    if got.dtype != torch.int64 or not torch.equal(got, again):
        raise AssertionError(f"SimHash kernel ({what}): two launches gave different words")
    if bool((got < 0).any()) or bool((got >= 2 ** bits).any()):
        raise AssertionError(f"SimHash kernel ({what}): words outside [0, 2^{bits})")
    return float(((got & sure) - (want & sure)).abs().max())


def plane_like(b: int, inp: int, gen, dev):
    import torch

    x = (torch.rand(b, inp, generator=gen, device=dev) < 0.2).float()
    tail = inp // 10
    x[:, -tail:] = torch.rand(b, tail, generator=gen, device=dev)
    return x.contiguous()


def check_simhash(eng, envs, gen, dev) -> dict:
    import torch

    from takzero_torch.models.network import NetConfig, simhash_matrix
    from takzero_torch.ops import simhash
    from takzero_torch.ops.repr import input_channels, state_to_planes

    planes = state_to_planes(eng, envs)
    planes[:, input_channels(eng.n) - 2] = 0.0
    x = planes.reshape(planes.shape[0], -1).contiguous()
    cases = ((128, 1296, 1), (1, 1296, 32), (37, 1001, 26), (5, 20, 7), (128, 2816, 32), (512, 1296, 32))
    for b, inp, bits in cases:
        xs = plane_like(b, inp, gen, dev)
        m = torch.randn(inp, bits, generator=gen, device=dev)
        expect_simhash_equal(xs, m, f"B={b} In={inp} bits={bits}")
    result = None
    for bits in (26, 32):
        m = simhash_matrix(NetConfig(n=6, hash_bits=bits), seed=0).to(dev)
        err = expect_simhash_equal(x, m, f"main-path planes, {bits} bits")
        b, inp = x.shape
        ms, how = device_ms(lambda: simhash.simhash_pack(x, m))
        plain, plain_how = device_ms(lambda: simhash.simhash_plain(x, m))
        out = dict(
            shape=[b, inp, bits], max_abs_err=err,
            near_zero_bits=int(((x.double() @ m.double()).abs() <= 1e-4).sum()),
            kernel_ms=ms, call_ms=call_ms(lambda: simhash.simhash_pack(x, m)),
            plain_ms=plain, library_ms=None, timing={"kernel": how, "plain": plain_how},
            cases_b_in_bits=cases,
        )
        out["bound_ms"], out["bound_by"] = bound_ms(b * inp * 4 + inp * bits * 4 + b * 8, 2 * b * inp * bits)
        log({"phase": f"kernel B simhash_pack, {bits} bits", **out})
        if bits == 26:  # the main path's width
            result = out
    return result


@contextlib.contextmanager
def tree_loops():
    """The search's batched loops and ``settle`` in place of the descent,
    settle and backup kernels, for the comparisons."""
    from takzero_torch.search import core

    kernels = core._tree_kernels
    core._tree_kernels = lambda tree: False
    try:
        yield
    finally:
        core._tree_kernels = kernels


def clone_tree(tree, device=None):
    """A copy of ``tree`` (on ``device``, by default its own)."""
    def copy(x):
        return x.clone() if device is None else x.to(device, copy=True)

    return tree._replace(**{f: copy(getattr(tree, f)) for f in tree._fields if f != "node_env"},
                         node_env=tree.node_env.map(copy))


def check_tree_kernels(dev) -> dict:
    """4b: the descent, settle, expansion and backup kernels against the
    batched loops on a searched tree at each selfplay cell's shape, and
    their times."""
    import torch

    from takzero_torch.ops import tree as tree_ops
    from takzero_torch.search import core
    from takzero_torch.search.agents import simple_evaluator
    from takzero_torch.search.gumbel import make_gumbel_search
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.search.tree import init_tree
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak.engine import engine

    out = {}
    b, k, budget, depth = 128, 64, 384, 48
    for n, c in ((6, 256), (5, 128)):
        eng = engine(n, half_komi=4)
        gen = torch.Generator(device=dev).manual_seed(n)
        envs = make_new_opening(eng)(torch.randint(0, 8, (b,), generator=gen, device=dev),
                                     torch.randint(0, 2, (b,), generator=gen, device=dev))
        evaluate = simple_evaluator(eng)
        tree = init_tree(eng, envs, 2 * budget + 8, c)
        tree, _ = make_gumbel_search(eng, evaluate, k, budget, max_depth=depth)(
            tree, gumbel_noise(gen, (b, c)), torch.zeros(b, device=dev))
        phases = core.make_simulate(eng, evaluate, max_depth=depth).phases
        beta = torch.zeros(b, device=dev)
        slot = tree.child_visit[:, 0].argmax(-1)  # the most visited root child: expanded
        for forced in (True, False):
            kern, loop = clone_tree(tree), clone_tree(tree)
            got = phases["descend"](kern, beta, slot if forced else None, forced)
            with tree_loops():
                want = phases["descend"](loop, beta, slot if forced else None, forced)
            torch.cuda.synchronize()
            for name, x in want.items():
                u, v = (got[name], x) if x.dtype != torch.float32 else (got[name].view(torch.int32), x.view(torch.int32))
                if not torch.equal(u, v):
                    raise AssertionError(f"descent kernel {n}x{n} forced={forced}: {name} differs from the loop's")
            expect_trees_close(kern, clone_tree(loop, "cpu"), f"descent kernel {n}x{n} forced={forced}", 0.0)
        # The backup of the forced descent's paths, after its evaluation.
        base = clone_tree(tree)
        rec = phases["forward"](base, beta, slot, True)
        logits, v_net, var_net = evaluate(rec["env_eval"])
        phases["apply_eval"](base, rec, logits, v_net, var_net)
        kern, loop = clone_tree(base), clone_tree(base)
        phases["backward"](kern, rec, v_net, var_net, True)
        with tree_loops():
            phases["backward"](loop, rec, v_net, var_net, True)
        torch.cuda.synchronize()
        expect_trees_close(kern, clone_tree(loop, "cpu"), f"backup kernel {n}x{n}", 0.0)

        # The settle of the forced descent's lanes, scratch row included.
        descended = clone_tree(tree)
        loop_state = phases["descend"](descended, beta, slot, True)
        kern, batched = clone_tree(descended), clone_tree(descended)
        got = phases["settle"](kern, loop_state)
        with tree_loops():
            want = phases["settle"](batched, loop_state)
        torch.cuda.synchronize()
        pairs = [(f"env_eval.{k}", got["env_eval"]._asdict()[k], x) for k, x in want["env_eval"]._asdict().items()]
        pairs += [(k, got[k], x) for k, x in want.items() if k != "env_eval"]
        pairs += [(f"tree.{k}", x, getattr(batched, k)) for k, x in kern._asdict().items() if k != "node_env"]
        for name, u, v in pairs:
            if u.dtype == torch.float32:
                u, v = u.view(torch.int32), v.view(torch.int32)
            if not torch.equal(u, v):
                raise AssertionError(f"settle kernel {n}x{n}: {name} differs from the batched settle's")

        # The expansion of the settled lanes (root, leaf and terminal ones),
        # scratch row included, from random bf16 logits.
        rec_settled = got
        x_logits = (torch.randn(b, eng.num_actions, generator=gen, device=dev) * 2).to(torch.bfloat16)
        x_v = torch.rand(b, generator=gen, device=dev) * 2 - 1
        x_var = torch.rand(b, generator=gen, device=dev) * 0.1
        expanded, batched = clone_tree(kern), clone_tree(kern)
        phases["apply_eval"](expanded, rec_settled, x_logits, x_v, x_var)
        with tree_loops():
            phases["apply_eval"](batched, rec_settled, x_logits, x_v, x_var)
        torch.cuda.synchronize()
        pairs = [(f"tree.{k}", x, getattr(batched, k)) for k, x in expanded._asdict().items() if k != "node_env"]
        pairs += [(f"node_env.{k}", x, y) for (k, x), y in zip(expanded.node_env._asdict().items(), batched.node_env)]
        for name, u, v in pairs:
            if u.dtype == torch.float32:
                u, v = u.view(torch.int32), v.view(torch.int32)
            if not torch.equal(u, v):
                raise AssertionError(f"expansion kernels {n}x{n}: {name} differs from the batched apply_eval's")
        masked, legal = tree_ops.expand_mask(rec_settled["env_eval"], x_logits, eng)
        top_vals, top_idx = core._kernel_a(masked, c)
        stored = clone_tree(kern)

        levels = int(torch.where(loop_state["active"], depth, loop_state["length"]).sum())
        up = int(rec["length"].clamp(min=1).sub(1).sum())  # levels j >= 1 under skip_root
        timed, rec_out = clone_tree(tree), core._descent_buffers(b, depth, dev)
        settled = clone_tree(descended)
        # A lane's settle reads its leaf's state and writes the evaluated
        # one (int32 height and tops, int64 colour bits a square; 28 bytes
        # of counters), reads its path and 64 bytes of the descent's
        # outputs, writes 24 of its own, and adds a visit on each edge.
        state_bytes = 16 * n * n + 28
        actions = eng.num_actions
        walks = {
            "descend": (lambda: tree_ops.tree_descend(timed, beta, slot, True, depth, rec_out),
                        lambda: phases["descend"](timed, beta, slot, True), levels,
                        levels * 8 * 4 * c + b * (depth * 8 + 48)),
            "settle": (lambda: tree_ops.tree_settle(settled, loop_state, eng, depth),
                       lambda: phases["settle"](settled, loop_state), int(loop_state["length"].sum()),
                       b * (2 * state_bytes + depth * 8 + 64 + 24) + 8 * int(loop_state["length"].sum())),
            # A lane's mask reads its state and its bf16 logits and writes
            # float32 logits; its store reads kernel A's children and its
            # state and writes 9 child rows, a state and a few scalars.
            "expand_mask": (lambda: tree_ops.expand_mask(rec_settled["env_eval"], x_logits, eng),
                            lambda: phases["apply_eval"](stored, rec_settled, x_logits, x_v, x_var), b,
                            b * (state_bytes + 6 * actions + 4 * legal.shape[1])),
            "expand_store": (lambda: tree_ops.expand_store(stored, rec_settled, top_vals, top_idx, legal, x_v, x_var),
                             lambda: phases["apply_eval"](stored, rec_settled, x_logits, x_v, x_var), b,
                             b * (8 * c + 36 * c + 2 * state_bytes + 64)),
            "backup": (lambda: tree_ops.tree_backup(timed, rec, v_net, var_net, True),
                       lambda: phases["backward"](timed, rec, v_net, var_net, True), up, up * 4 * 4 * c),
        }
        for name, (fn, loops_fn, levels_of, nbytes) in walks.items():
            ms, how = device_ms(fn)
            with tree_loops():
                loops_ms = call_ms(loops_fn, iters=20, warmup=3)
                extra = {"loops_device_ms": device_ms(loops_fn)[0]} if name not in ("descend", "backup") else {}
            row = dict(shape=[b, c], levels=levels_of, kernel_ms=ms, call_ms=call_ms(fn), loops_call_ms=loops_ms,
                       **extra, bytes=nbytes, timing={"kernel": how})
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 0)
            log({"phase": f"tree kernel {name}, {n}x{n}", **row})
            out[f"{name}_{n}x{n}"] = row
    return out


@contextlib.contextmanager
def cudnn_folded_path():
    """Inside, the bf16 folded path on the card takes the cuDNN TF32
    convolutions of float32 copies that the kernel replaced (``_conv2d``,
    the float32 path's code): the library yardstick of phase 4c."""
    from takzero_torch.models import network

    takes = network._takes_kernel
    network._takes_kernel = lambda dtype, x: False
    try:
        yield
    finally:
        network._takes_kernel = takes


def expect_conv_layer(x, layer, residual, what: str):
    """One launch of the convolution kernel on ``x`` (the stem's float32
    NCHW planes or bf16 NHWC activations) against the same function on the
    same operands: a bf16 output within one rounding of the plain version
    (plus 2e-5 of sum |x*w| + |residual|, the two float32 sums' orders),
    the head's float32 outputs (policy, relued value and UBE maps) within
    1e-5 of sum |x*w| of float64.  Returns the kernel's output and its
    largest error: a share of one rounding, or of sum |x*w|."""
    import torch
    import torch.nn.functional as F

    from takzero_torch.ops import conv

    got = conv.conv3x3(x, layer, residual)
    w64 = conv.unpack_weight(layer.weight).double()
    x64 = x.to(torch.bfloat16).double() if x.dtype == torch.float32 else x.permute(0, 3, 1, 2).double()
    x64 = F.pad(x64, (0, 0, 0, 0, 0, w64.shape[1] - x64.shape[1]))
    acc = F.conv2d(x64, w64, padding=1) + layer.bias.double()[None, :, None, None]
    scale = F.conv2d(x64.abs(), w64.abs(), padding=1)
    if layer.split is not None:
        policy, heads = (acc[:, : layer.split].flatten(1), scale[:, : layer.split].flatten(1)), \
            (F.relu(acc[:, layer.split : layer.cout]).flatten(2), scale[:, layer.split : layer.cout].flatten(2))
        err = max(float(((g.double() - want).abs() / sc.clamp(min=1e-30)).max())
                  for g, (want, sc) in zip(got, (policy, heads)) if g.numel())
        if err > 1e-5:
            raise AssertionError(f"conv kernel, {what}: float32 error {err:.3g} of sum|x*w| > 1e-5")
        return got, err
    plain = conv.conv3x3_plain(x, layer, residual).float()
    bound = scale if residual is None else scale + residual.permute(0, 3, 1, 2).double().abs()
    one_rounding = torch.maximum(plain.abs(), got.float().abs()) * 2.0 ** -7 + 2e-5 * bound.permute(0, 2, 3, 1).float()
    err = float(((got.float() - plain).abs() / one_rounding).max())
    if err > 1:
        raise AssertionError(f"conv kernel, {what}: bf16 output {err:.3g} roundings from the plain version")
    return got, err


def check_conv_kernel(dev) -> dict:
    """4c: the evaluator's convolution kernel (``ops/conv.py``) at the
    selfplay cells' tower layer [128, n x n, 256 -> 256] with its residual,
    against float64 (the unrounded float32 sum, within 1e-5 of sum |x*w|)
    and its plain version (the bf16 output within one rounding); its times
    beside its bound (FLOPs at 989 TFLOP/s), the plain version's and the
    present path's (cuDNN TF32 on float32 copies, plus the residual, relu
    and cast).  Then the whole bf16 evaluator at the cell's widths, 128
    rows, a launch at a time (:func:`expect_conv_layer`): the stem on the
    float32 planes (4n+12 channels, padded), each tower layer, and the head
    (policy, value and UBE channels) on the tiles the main path takes;
    ``apply_folded``'s outputs must be that chain's bit for bit, in
    2 blocks + 2 launches; device time through the kernel and through the
    cuDNN path."""
    import torch
    import torch.nn.functional as F

    from takzero_torch.models import network
    from takzero_torch.ops import conv
    from takzero_torch.ops.repr import input_channels

    out = {}
    b, c = 128, 256
    for n, blocks in ((6, 16), (5, 20)):
        gen = torch.Generator().manual_seed(n)
        x = torch.randn(b, n, n, c, generator=gen).to(torch.bfloat16).to(dev)
        res = torch.randn(b, n, n, c, generator=gen).to(torch.bfloat16).to(dev)
        layer = conv._layer((torch.randn(c, c, 3, 3, generator=gen) / 48).to(dev),
                            (torch.randn(c, generator=gen) * 0.1).to(dev))
        raw = conv.ConvLayer(layer.weight, layer.bias, c, c, split=c)  # f32 out, unrelued
        _, rel = expect_conv_layer(x, raw, None, f"{n}x{n} tower layer, float32 sum")
        _, ulps = expect_conv_layer(x, layer, res, f"{n}x{n} tower layer")
        flops, nbytes = 2.0 * b * n * n * c * c * 9, 3 * b * n * n * c * 2 + layer.weight.numel() * 2
        xc, wc = x.permute(0, 3, 1, 2).contiguous(), conv.unpack_weight(layer.weight).contiguous()
        rc = res.permute(0, 3, 1, 2).contiguous()

        def library():
            with network.conv_precision(torch.bfloat16):
                return F.relu(rc.float() + network._conv2d(xc, wc, layer.bias, torch.bfloat16)).to(torch.bfloat16)

        ms, how = device_ms(lambda: conv.conv3x3(x, layer, res))
        row = dict(shape=[b, n, n, c, c], tile=list(conv.choose_tile(b * n * n, c)), kernel_ms=ms,
                   call_ms=call_ms(lambda: conv.conv3x3(x, layer, res)),
                   plain_ms=call_ms(lambda: conv.conv3x3_plain(x, layer, res), iters=20, warmup=3),
                   library_ms=device_ms(library)[0], bound_ms=max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                   bound_by="operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
                   tflops=flops / ms / 1e9, f32_err_over_sum_abs_products=rel, bf16_err_in_roundings=ulps,
                   timing={"kernel": how})
        cfg = network.NetConfig(n=n, filters=c, blocks=blocks)
        fw = network.fold_inference_params(cfg, network.init_network(cfg, 1).to(dev))
        packed = fw["packed"]
        planes = torch.randint(0, 2, (b, input_channels(n), n, n), generator=gen).float().to(dev)
        core, stem_err = expect_conv_layer(planes, packed["stem"], None, f"{n}x{n} stem")
        tower_err = 0.0
        for i, (la, lb) in enumerate(packed["blocks"]):
            y, e1 = expect_conv_layer(core, la, None, f"{n}x{n} block {i} a")
            core, e2 = expect_conv_layer(y, lb, core, f"{n}x{n} block {i} b")
            tower_err = max(tower_err, e1, e2)
        (policy, heads), head_err = expect_conv_layer(core, packed["head"], None, f"{n}x{n} head")
        chain = (policy, network._dense_head(heads[:, 0], fw["value"], True),
                 network._dense_head(heads[:, 1], fw["ube"], False))
        before = launch_counts()["conv3x3"]
        kernel_out = network.apply_folded(cfg, fw, planes)
        launches = launch_counts()["conv3x3"] - before
        if launches != 2 * blocks + 2:
            raise AssertionError(f"evaluator {n}x{n}: {launches} convolution launches, expected {2 * blocks + 2}")
        for name, got, want in zip(("policy", "value", "ube"), kernel_out, chain):
            if not torch.equal(got, want):
                raise AssertionError(f"evaluator {n}x{n}: apply_folded's {name} is not the checked chain's")
        with cudnn_folded_path():
            cudnn_ms = device_ms(lambda: network.apply_folded(cfg, fw, planes), calls=5)[0]
        row["evaluator"] = dict(
            launches=launches, kernel_ms=device_ms(lambda: network.apply_folded(cfg, fw, planes), calls=5)[0],
            cudnn_ms=cudnn_ms,
            tiles={k: list(conv.choose_tile(b * n * n, packed[k].cout_pad)) for k in ("stem", "head")},
            stem_err_in_roundings=stem_err, tower_err_in_roundings=tower_err,
            head_f32_err_over_sum_abs_products=head_err)
        log({"phase": f"conv kernel, {n}x{n}", "card": card_line(), **row})
        out[f"{n}x{n}"] = row
    return out


def check_topk_8x8(gen, dev) -> dict:
    """3b: kernel A on rows too wide for shared memory, 8x8's f32[128, 65216]:
    masked logits of random 8x8 positions and the adversarial rows, with
    k=1, 256 and A, values bit for bit and indices exactly; timed at k=256
    on the masked logits."""
    import torch

    from takzero_torch.ops import topk
    from takzero_torch.tak.engine import engine

    eng = engine(8, half_komi=4)
    legal = eng.legal_mask(random_positions(eng, 128, 40, gen, dev))
    b, a = legal.shape
    rows = torch.where(legal, torch.randn(b, a, generator=gen, device=dev), NEG).contiguous()
    hard = adversarial_rows(a, gen, dev)
    for k in (1, 256, a):
        expect_topk_equal(rows, k, f"8x8 masked logits k={k}")
        expect_topk_equal(hard, k, f"8x8 adversarial rows k={k}")
    k = 256
    ms, how = device_ms(lambda: topk.exact_top_k_unsorted(rows, k))
    out = dict(shape=[b, a], k=k, rows_fewer_than_k_legal=int((legal.sum(-1) < k).sum()),
               adversarial_cases_a_k=[[a, kk] for kk in (1, 256, a)], max_abs_err=0.0, kernel_ms=ms,
               adversarial_rows_kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(hard, k))[0],
               call_ms=call_ms(lambda: topk.exact_top_k_unsorted(rows, k)),
               plain_ms=device_ms(lambda: topk.topk_plain(rows, k))[0],
               library_ms=device_ms(lambda: torch.topk(rows, k, sorted=False))[0], timing=how)
    out["bound_ms"], out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    log({"phase": "kernel A at 8x8 (rows wider than shared memory)", "card": card_line(), **out})
    return out


TREE_FLOATS = ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")


def expect_trees_close(a, b, what: str, tol: float) -> None:
    """Tree ``a`` (card) against ``b`` (CPU) outside the scratch row: every
    integer array equal, the float arrays of TREE_FLOATS within ``tol``."""
    import torch

    for name, x in a._asdict().items():
        y = getattr(b, name)
        for u, v in (zip(x, y) if name == "node_env" else [(x, y)]):
            u = u.cpu()
            if u.dim() >= 2 and name != "free_rows":
                u, v = u[:, :-1], v[:, :-1]
            if name in TREE_FLOATS:
                torch.testing.assert_close(u, v, rtol=tol, atol=tol, msg=lambda m: f"{what}: {name}: {m}")
            elif not torch.equal(u, v):
                raise AssertionError(f"{what}: {name} differs between the card and the CPU")


def run_search_8x8(dev, gen) -> dict:
    """3c: the Gumbel search at 8x8.  (a) The small net of
    tests/test_torch_bigboards.py (8 filters, 1 block, float32, no novelty;
    2 games, k=4, budget 16, 24 rows, C=64) on the card against the CPU:
    trees equal, floats within 1e-4 (summation order).  (b) One search at
    the default 16x256 bf16 width with SimHash over 2^32 bits: 128 games,
    k=8, budget 24, C=256: chosen actions legal, the root-visit invariant,
    and both kernels launched budget+1 times."""
    import torch

    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.search.core import with_agent
    from takzero_torch.search.gumbel import make_gumbel_search
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.search.policy import slot_action
    from takzero_torch.search.tree import init_tree
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak.engine import engine

    eng = engine(8, half_komi=4)
    small = NetConfig(n=8, half_komi=4, filters=8, blocks=1, novelty="none", compute_dtype=torch.float32)
    cpu_gen = torch.Generator().manual_seed(8)
    sym, pair = torch.randint(0, 8, (2,), generator=cpu_gen), torch.randint(0, 2, (2,), generator=cpu_gen)
    gumbel = gumbel_noise(cpu_gen, (2, 64))
    trees = {}
    for where in ("cpu", dev):
        agent = new_agent(small, seed=0, device=where)
        evaluate = make_net_evaluate(small, eng, device=where)
        envs = make_new_opening(eng)(sym.to(where), pair.to(where))
        search = make_gumbel_search(eng, with_agent(evaluate, agent), 4, 16, max_depth=16)
        trees[str(where)] = search(init_tree(eng, envs, 24, 64), gumbel.to(where), torch.zeros(2, device=where))
    (t_card, s_card), (t_cpu, s_cpu) = trees[str(dev)], trees["cpu"]
    expect_trees_close(t_card, t_cpu, "8x8 search, small net", 1e-4)
    if not torch.equal(s_card.cpu(), s_cpu):
        raise AssertionError("8x8 search, small net: chosen slots differ between the card and the CPU")

    cfg = NetConfig(n=8, half_komi=4)  # 16x256 bf16, SimHash over 2^32 bits
    batch, k, budget, children = 128, 8, 24, 256
    agent = new_agent(cfg, seed=0, device=dev)
    evaluate = make_net_evaluate(cfg, eng, device=dev)
    envs = random_positions(eng, batch, 16, gen, dev)
    search = make_gumbel_search(eng, with_agent(evaluate, agent), k, budget, max_depth=48)
    tree = init_tree(eng, envs, budget + 8, children)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    tree, slot = search(tree, gumbel_noise(gen, (batch, children)), torch.zeros(batch, device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _expect_launches("8x8 search at 16x256", per_simulation(cfg), budget + 1)
    action = slot_action(tree, slot).to(torch.int64)
    if not bool(eng.legal_mask(envs).gather(1, action[:, None]).all()):
        raise AssertionError("8x8 search: an illegal action was chosen")
    valid = tree.child_action[:, 0, :] >= 0
    if not torch.equal(tree.root_visit.long(), torch.where(valid, tree.child_visit[:, 0, :], 0).sum(-1).long() + 1):
        raise AssertionError("8x8 search: a root's visits are not its children's plus one")
    for name in TREE_FLOATS[2:]:
        if not bool(torch.isfinite(getattr(tree, name)).all()):
            raise AssertionError(f"8x8 search: non-finite {name}")
    out = {"phase": "8x8 search", "card": card_line(), "small_net_card_vs_cpu": "trees equal (floats 1e-4)",
           "net": "8x8 16x256 bf16, SimHash 2^32", "batch": batch, "k": k, "budget": budget, "children": children,
           "seconds": seconds, "sims_per_s": batch * (budget + 1) / seconds, "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(out)
    del agent, tree
    torch.cuda.empty_cache()
    return out


def check_small_reference(dev) -> None:
    """The 3x3 move program and a small network, on the card vs the CPU."""
    import dataclasses

    import torch

    from takzero_torch.config import NET_PRESETS, selfplay_preset
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import _conv2d, conv_precision
    from takzero_torch.ops import conv
    from takzero_torch.search.agents import dummy_evaluator
    from takzero_torch.selfplay import SelfplayEngine, make_draws
    from takzero_torch.tak.engine import engine

    eng = engine(3)
    sp_cfg = selfplay_preset("tiny3", batch=8, search_budget=16, sampled_actions=4, max_children=32)
    factory = lambda agent, envs: dummy_evaluator(eng)(envs)  # noqa: E731
    runs = {}
    for where in ("cpu", "cuda"):
        sp = SelfplayEngine(eng, sp_cfg, factory, device=where)
        gen = torch.Generator().manual_seed(3)
        sp.reset({k: v.to(where) for k, v in make_draws(gen, 8, 32).items()})
        envs, tree, out = sp.envs, sp.tree, []
        for _ in range(4):
            draws = {k: v.to(where) for k, v in make_draws(gen, 8, 32).items()}
            envs, tree, packed, _ = sp.move(envs, tree, None, draws)
            out.append(packed.cpu())
        runs[where] = torch.stack(out)
    c = sp_cfg.max_children
    ints = torch.cat([runs["cpu"][..., :4], runs["cpu"][..., 5 + c:]], -1)
    ints_gpu = torch.cat([runs["cuda"][..., :4], runs["cuda"][..., 5 + c:]], -1)
    if not torch.equal(ints, ints_gpu):
        raise AssertionError("3x3 move program: integer columns differ between card and CPU")
    floats = runs["cpu"][..., 4:5 + c].view(torch.float32)
    floats_gpu = runs["cuda"][..., 4:5 + c].view(torch.float32)
    torch.testing.assert_close(floats_gpu, floats, rtol=1e-5, atol=1e-5)

    envs = random_positions(eng, 64, 8, torch.Generator().manual_seed(4), "cpu")
    report = {"phase": "small reference", "move_program_3x3": "card == cpu"}
    # float32 within 1e-4 (summation order); bf16 within 1e-2, about two
    # bf16 steps of these outputs: both sides accumulate exact products in
    # float32, and only a float32 sum that lands within rounding of a bf16
    # boundary can round the other way on the other side.
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        cfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=dtype)
        agent_cpu = new_agent(cfg, seed=2, device="cpu")
        agent_gpu = new_agent(cfg, seed=2, device=dev)
        want = make_net_evaluate(cfg, eng, device="cpu")(agent_cpu, envs)
        got = make_net_evaluate(cfg, eng, device=dev)(agent_gpu, envs.map(lambda t: t.to(dev)))
        name = str(dtype).split(".")[-1]
        for g, w, what in zip(got, want, ("policy", "value", "variance")):
            torch.testing.assert_close(g.cpu(), w, rtol=tol, atol=tol, msg=lambda m: f"{name} {what}: {m}")
        agree = float((got[0].cpu().argmax(-1) == want[0].argmax(-1)).float().mean())
        if agree < 0.95:
            raise AssertionError(f"{name} network: policy argmax agrees on {agree:.3f} of positions")
        report[f"network_{name}"] = {
            "tolerance": tol, "policy_argmax_agreement": agree,
            "max_abs_diff": max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want)),
        }

    # One bf16 convolution at the flagship width against float64, through
    # the evaluator's kernel (its head launch's float32 output: the sum
    # before any rounding) and through cuDNN's TF32 (``_conv2d``, which the
    # learner's modules still take): the products of bf16 values are exact,
    # so the card's error must stay at float32 summation level (a Winograd
    # or FFT algorithm would not).
    gen = torch.Generator().manual_seed(5)
    xc = torch.randn(32, 256, 6, 6, generator=gen).to(torch.bfloat16)
    wc = (torch.randn(256, 256, 3, 3, generator=gen) / 48).to(torch.bfloat16)
    layer = conv._layer(wc.to(dev), torch.zeros(256, device=dev), split=256)
    before = launch_counts()["conv3x3"]
    kernel = conv.conv3x3(xc.to(dev).permute(0, 2, 3, 1).contiguous(), layer)[0].view(32, 256, 6, 6)
    if launch_counts()["conv3x3"] != before + 1:
        raise AssertionError("the float64 check did not launch the convolution kernel")
    with conv_precision(torch.bfloat16):
        cudnn = _conv2d(xc.to(dev), wc.to(dev), torch.zeros(256, device=dev), torch.bfloat16)
    ref = torch.nn.functional.conv2d(xc.double(), wc.double(), padding=1)
    scale = torch.nn.functional.conv2d(xc.double().abs(), wc.double().abs(), padding=1)
    rel = {name: float(((got.cpu().double() - ref).abs() / scale.clamp(min=1e-30)).max())
           for name, got in (("conv3x3_bf16_kernel", kernel), ("cudnn_tf32", cudnn))}
    report["conv_bf16_vs_float64"] = {"max_err_over_sum_abs_products": rel, "limit": 1e-5}
    log(report)
    for name, err in rel.items():
        if err > 1e-5:
            raise AssertionError(f"bf16 convolution on the card ({name}): error {err:.3g} of sum|x*w| > 1e-5")


def run_main_path(dev) -> tuple[dict, object]:
    import torch

    from takzero_torch import bench
    from takzero_torch.tak.engine import engine

    # The flagship configuration, one timed move after the warm-up (the
    # bench's default is two: cut to keep the smoke inside its time).
    cfg = bench.BenchConfig(moves=1)
    zero_launches()
    res = bench.run(cfg, device=dev)
    # Each simulation: one descent, one settle, one expansion top-k
    # (kernel A), one SimHash (kernel B), one backup and one evaluation of
    # 2 blocks + 2 convolution launches, graph replays included.
    launches = launch_counts()
    expect = (cfg.budget + 1) * (cfg.moves + 1)  # the warm-up move included
    for name, count in launches.items():
        want = expect * (2 * cfg.blocks + 2 if name == "conv3x3" else 1)
        if count != want:
            raise AssertionError(f"{name}: {count} launches on the main path, expected {want}")

    eng = engine(6, half_komi=4)
    action = res.packed[:, 0].to(dev, torch.int64)
    legal = eng.legal_mask(res.envs_before).gather(1, action[:, None])[:, 0]
    if not bool(legal.all()):
        raise AssertionError(f"illegal actions chosen in lanes {(~legal).nonzero()[:, 0].tolist()}")
    tree = res.tree
    live = tree.node_live[:, :, None].expand_as(tree.child_value)
    for name in ("child_value", "child_std", "child_prob"):
        if not bool(torch.isfinite(getattr(tree, name)[live]).all()):
            raise AssertionError(f"non-finite {name} in the tree")
    for name in ("root_value", "root_std"):
        if not bool(torch.isfinite(getattr(tree, name)).all()):
            raise AssertionError(f"non-finite {name}")
    c = res.max_children
    pol = res.packed[:, 5:5 + c].view(torch.float32)
    if not torch.allclose(pol.sum(-1), torch.ones(pol.shape[0]), atol=1e-4):
        raise AssertionError("improved policy rows do not sum to 1")
    line = res.json_line()
    log({
        "phase": "main path", **line,
        "seconds_per_move": res.per_move_s, "warmup_move_s": res.warmup_s,
        "launches": launches, "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    })
    return launches, res


def _train_pair(cfg, dev, steps: int = 2):
    """``steps`` train steps of one tiny agent on the CPU and on ``dev``."""
    import numpy as np
    import torch

    from takzero_torch.data.native_loader import make_batch_native
    from takzero_torch.models.agent import new_agent
    from takzero_torch.tak.engine import engine
    from takzero_torch.train.data import random_pretraining_targets
    from takzero_torch.train.learner import make_optimizer, make_train_step

    eng = engine(cfg.n, half_komi=cfg.half_komi)
    lines = [t.to_line() for t in random_pretraining_targets(eng, 64 * steps, np.random.default_rng(7), device="cpu")]
    out = {}
    for where in ("cpu", dev):
        agent = new_agent(cfg, seed=2, device=where)
        opt, step = make_optimizer(agent), make_train_step(cfg)
        rng = np.random.default_rng(8)
        metrics = []
        for k in range(steps):
            batch = make_batch_native(eng, "\n".join(lines[64 * k:64 * (k + 1)]) + "\n", rng, device=where)
            metrics.append({name: float(v) for name, v in step(agent, opt, batch, k > 0).items()})
        out[str(where)] = (agent, metrics)
    return out["cpu"], out[str(dev)]


def check_learner_small_reference(dev) -> None:
    """Two tiny3 train steps, card against CPU, in float32 and bf16."""
    import dataclasses

    import torch

    from takzero_torch.config import NET_PRESETS

    report = {"phase": "learner small reference"}
    # float32 (TF32 off): metrics within 1e-4 and BN statistics within 1e-4
    # (summation order).  bf16: every convolution rounds its result to
    # bf16, so a sum that lands within rounding of a bf16 boundary rounds
    # the other way on the other side: 5e-2.  Parameters: Adam's first
    # step moves an entry by lr * sign(g) whatever |g|, so an entry whose
    # gradient is at rounding level may move the other way: each entry
    # within 4e-4 (two steps of lr 1e-4 each way), and the share off by
    # more than 1e-6 is reported.
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        cfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=dtype)
        (a_cpu, m_cpu), (a_gpu, m_gpu) = _train_pair(cfg, dev)
        name = str(dtype).split(".")[-1]
        worst = 0.0
        for mc, mg in zip(m_cpu, m_gpu):
            for k in mc:
                worst = max(worst, abs(mc[k] - mg[k]))
                if not abs(mc[k] - mg[k]) <= tol * max(1.0, abs(mc[k])):
                    raise AssertionError(f"learner {name}: {k} {mg[k]} on the card, {mc[k]} on the CPU")
        off, total, stat_err, param_err = 0, 0, 0.0, 0.0
        want = a_cpu["net"].state_dict()
        for key, got in a_gpu["net"].state_dict().items():
            got, w = got.cpu(), want[key]
            if key.endswith("num_batches_tracked"):
                continue
            err = float((got - w).abs().max())
            if key.endswith(("running_mean", "running_var")):
                stat_err = max(stat_err, err)
                if err > tol * max(1.0, float(w.abs().max())):
                    raise AssertionError(f"learner {name}: BN statistic {key} off by {err}")
                continue
            param_err = max(param_err, err)
            if err > 4e-4:
                raise AssertionError(f"learner {name}: parameter {key} off by {err}")
            off += int(((got - w).abs() > 1e-6).sum())
            total += w.numel()
        if not torch.equal(a_gpu["hash_bits"].cpu(), a_cpu["hash_bits"]):
            raise AssertionError(f"learner {name}: SimHash seen-sets differ between card and CPU")
        report[name] = {"tolerance": tol, "max_metric_diff": worst, "max_bn_stat_diff": stat_err,
                        "max_param_diff": param_err, "params_off_by_more_than_1e-6": off,
                        "params": total, "seen_set": "card == cpu"}
    log(report)


def train_step_flops(cfg, batch: int) -> float:
    """Operations of one train step's convolutions: forward, and the two
    backward products (input and weight gradients), 2 FLOP per
    multiply-add; the heads' 1x1 convolutions and dense layers and the
    elementwise work are left out (under 0.1%)."""
    from takzero_torch.ops.repr import input_channels

    per_position = 9 * cfg.filters * (input_channels(cfg.n) + 2 * cfg.blocks * cfg.filters + cfg.output_channels)
    return 3 * 2 * batch * cfg.n * cfg.n * per_position


def profile_device(fn, calls: int = 3, ranges: tuple = ()) -> dict:
    """Device time per call of ``fn`` under the profiler: kernels and
    copies summed, the convolutions' (forward and backward, every kernel
    under them), the idle share of the wall time, the kernels that take
    the most (their totals over the ``calls`` calls), and the host time per
    call inside each ``record_function`` range named in ``ranges``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from takzero_torch.profile_move import _device_total_us, _device_us, _top

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # A user annotation (the optimizer's step and zero_grad) also shows as a
    # device range over the kernels it launched: count kernels only.
    rows = [r for r in prof.key_averages() if not getattr(r, "is_user_annotation", False)]
    on_device = [e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    conv_us = sum(_device_total_us(r) for r in rows if r.key in ("aten::convolution", "aten::convolution_backward"))
    out = {
        "device_busy_ms": device_us / 1e3 / calls, "device_events": len(on_device) // calls,
        "wall_ms_under_profiler": wall * 1e3 / calls,
        "idle_share_under_profiler": 1.0 - device_us / 1e6 / wall, "conv_device_ms": conv_us / 1e3 / calls,
        "top_by_device": _top([r for r in rows if r.device_type == DeviceType.CUDA], _device_us, 6),
    }
    if ranges:
        host = {r.key: r.cpu_time_total for r in prof.key_averages()
                if r.key in ranges and r.device_type == DeviceType.CPU}  # not the ranges' device rows
        out["host_ms_by_range"] = {k: host.get(k, 0.0) / 1e3 / calls for k in ranges}
    return out


def _expected_learner_launches(pretrain_steps: int, runs) -> int:
    """Kernel B launches the driver's calls imply: a pre-training step
    hashes its batch twice (fresh bits, then the update); a loop chunk
    hashes all its batches once for the fresh bits and each step hashes
    its batch once."""
    from takzero_torch.config import LearnConfig
    from takzero_torch.drivers.learn import chunk_len

    total = 2 * pretrain_steps
    for start, steps, chunk, per_ckpt in runs:
        cfg = LearnConfig(steps_per_checkpoint=per_ckpt)
        model, target = start, start + steps
        while model < target:
            c = chunk_len(model, chunk, cfg, cross_reanalyze=False, target_steps=target)
            total += c + 1
            model += c
    return total


def run_learner_main_path(dev) -> dict:
    """The learn driver at net6_simhash full width, in a temporary directory."""
    import json
    import math
    import tempfile

    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.data.native_loader import make_batch_native
    from takzero_torch.drivers import learn
    from takzero_torch.models.agent import new_agent
    from takzero_torch.ops.bitset import bitset_init, bitset_set
    from takzero_torch.ops.repr import input_channels
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.tak.engine import engine
    from takzero_torch.train.data import random_pretraining_targets
    from takzero_torch.train.learner import make_optimizer, make_train_step
    from takzero_torch.utils import ckpt

    cfg = NET_PRESETS["net6_simhash"]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    pretrain = 10
    # (start, steps, chunk, checkpoint cadence): each run ends on a step
    # checkpoint, which the next run resumes from and the checks load.
    runs = [(10, 10, 1, 10), (20, 20, 4, 20)]
    with tempfile.TemporaryDirectory(prefix="takzero_learn_") as d:
        common = ["--directory", d, "--net", "net6_simhash", "--batch-size", "128", "--no-wait",
                  "--seed", "0", "--device", str(dev)]
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        t0 = time.perf_counter()
        learn.main(common + ["--pretrain-targets", "1280", "--pretrain-steps", str(pretrain), "--max-steps", "0",
                             "--steps-per-checkpoint", "10"])
        pretrain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = [t.to_line() for t in random_pretraining_targets(eng, 1280, np.random.default_rng(1), device=dev)]
        co.append_lines(d, co.TARGETS_SELFPLAY, lines)
        targets_s = time.perf_counter() - t0
        loop = []
        for start, steps, chunk, per_ckpt in runs:
            loop.append(learn.main(common + ["--pretrain-steps", "0", "--max-steps", str(steps),
                                             "--chunk-steps", str(chunk), "--steps-per-checkpoint", str(per_ckpt)]))
        torch.cuda.synchronize(dev)
        launches = _launches(*AB)
        expect = _expected_learner_launches(pretrain, runs)
        if launches != {"exact_top_k_unsorted": 0, "simhash_pack": expect}:
            raise AssertionError(f"learner launches {launches}, expected kernel B {expect} and kernel A 0")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        rows = [json.loads(x) for x in open(f"{d}/metrics.jsonl", encoding="utf-8").read().splitlines()]
        if [r["step"] for r in rows] != list(range(pretrain + 1, pretrain + 1 + sum(r[1] for r in runs))):
            raise AssertionError(f"metrics.jsonl steps {[r['step'] for r in rows]}")
        if not all(math.isfinite(r[k]) for r in rows for k in ("loss", "loss_policy", "loss_value", "loss_ube")):
            raise AssertionError("non-finite loss in metrics.jsonl")
        last_step, path = ckpt.model_path_with_most_steps(d)
        if last_step != runs[-1][0] + runs[-1][1]:
            raise AssertionError(f"last step checkpoint {path}, expected step {runs[-1][0] + runs[-1][1]}")
        agent = ckpt.load_checkpoint(path, new_agent(cfg, seed=5, device=dev))
        idx, _ = ckpt.read_hash_indices(f"{d}/{ckpt.HASH_LOG}", 0)
        rebuilt = bitset_set(bitset_init(cfg.hash_bits, dev), torch.from_numpy(idx.astype(np.int64)).to(dev))
        if not torch.equal(rebuilt, agent["hash_bits"]):
            raise AssertionError("the last checkpoint's seen-set differs from the one rebuilt from hash_log.bin")
        bits_set = int(idx.size)

        # One full-width train step on one resident batch, after warm-up.
        batch = make_batch_native(eng, "\n".join(lines[:512]) + "\n", np.random.default_rng(2), splits=4, device=dev)
        x = batch.planes.reshape(512, -1).clone()
        x.view(512, input_channels(cfg.n), -1)[:, input_channels(cfg.n) - 2] = 0.0
        err = max(expect_simhash_equal(x[:128].contiguous(), agent["hash_matrix"], "learner planes, 128 rows"),
                  expect_simhash_equal(x, agent["hash_matrix"], "learner planes, 512 rows"))
        one = type(batch)(*(t[0] for t in batch))
        opt, step = make_optimizer(agent), make_train_step(cfg)
        for _ in range(3):
            step(agent, opt, one, True)
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            step(agent, opt, one, True)
        end.record()
        torch.cuda.synchronize(dev)
        step_ms = start.elapsed_time(end) / 10
        busy = profile_device(lambda: step(agent, opt, one, True))

    steps = sum(r["steps"] for r in loop)
    seconds = sum(r["seconds"] for r in loop)
    out = {
        "phase": "learner main path", "net": "net6_simhash (16x256 bf16, SimHash 2^32)", "batch": 128,
        "card": card_line(), "steps_per_s": steps / seconds,
        "steps_per_s_by_run": [r["steps"] / r["seconds"] for r in loop],
        "chunks": [[r[2], r[1]] for r in runs],
        "train_step_device_ms": step_ms, "train_step_bound_ms": train_step_flops(cfg, 128) / TF32_FLOPS * 1e3,
        "train_step_profile": busy, "host_assembly_share": sum(r["assemble_seconds"] for r in loop) / seconds,
        "peak_memory_gb": peak_gb, "pretrain_seconds": pretrain_s, "selfplay_targets_seconds": targets_s,
        "launches": launches, "hash_log_bits": bits_set, "kernel_b_learner_planes_err": err,
        "metrics_rows": len(rows), "last_loss": rows[-1]["loss"],
    }
    log(out)
    return launches


def check_kernels_4x4(gen, dev) -> dict:
    """Both kernels at the 4x4 shapes of the actor-learner loop: kernel A at
    f32[128, 944] with k=1, 128 and 944 on masked 4x4 logits and on the
    adversarial rows, kernel B on 4x4 planes; each timed at the loop's
    shape (A: k=128)."""
    import torch

    from takzero_torch.models.network import NetConfig, simhash_matrix
    from takzero_torch.ops import simhash, topk
    from takzero_torch.ops.repr import input_channels, state_to_planes
    from takzero_torch.tak.engine import engine

    eng = engine(4, half_komi=4)
    envs = random_positions(eng, 128, 24, gen, dev)
    legal = eng.legal_mask(envs)
    b, a = legal.shape
    rows = torch.where(legal, torch.randn(b, a, generator=gen, device=dev), NEG).contiguous()
    hard = adversarial_rows(a, gen, dev)
    for k in (1, 128, a):
        expect_topk_equal(rows, k, f"4x4 masked logits k={k}")
        expect_topk_equal(hard, k, f"4x4 adversarial rows k={k}")
    k = 128
    a_out = dict(shape=[b, a], k=k, max_abs_err=0.0,
                 kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(rows, k))[0],
                 plain_ms=device_ms(lambda: topk.topk_plain(rows, k))[0],
                 library_ms=device_ms(lambda: torch.topk(rows, k, sorted=False))[0])
    a_out["bound_ms"], a_out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)

    planes = state_to_planes(eng, envs)
    planes[:, input_channels(4) - 2] = 0.0
    x = planes.reshape(b, -1).contiguous()
    m = simhash_matrix(NetConfig(n=4, hash_bits=32), seed=0).to(dev)
    inp, bits = m.shape
    b_out = dict(shape=[b, inp, bits], max_abs_err=expect_simhash_equal(x, m, "4x4 planes, 32 bits"),
                 kernel_ms=device_ms(lambda: simhash.simhash_pack(x, m))[0],
                 plain_ms=device_ms(lambda: simhash.simhash_plain(x, m))[0], library_ms=None)
    b_out["bound_ms"], b_out["bound_by"] = bound_ms(b * inp * 4 + inp * bits * 4 + b * 8, 2 * b * inp * bits)
    log({"phase": "kernels at 4x4", "exact_top_k_unsorted": a_out, "simhash_pack": b_out})
    return {"exact_top_k_unsorted": a_out, "simhash_pack": b_out}


def _launches(*names) -> dict:
    """The launch counters (``takzero_torch/ops/_build.py``) of ``names``."""
    counts = launch_counts()
    return {name: counts[name] for name in names}


def per_evaluation(cfg) -> dict:
    """The launches of one evaluation of ``cfg``'s net: kernel B once on a
    SimHash net; the convolution kernel for the stem, two a block and the
    heads in bf16, none in float32, whose folded path keeps ``_conv2d``."""
    import torch

    return {"simhash_pack": int(cfg.novelty == "simhash"),
            "conv3x3": 2 * cfg.blocks + 2 if cfg.compute_dtype == torch.bfloat16 else 0}


def per_simulation(cfg) -> dict:
    """The launches of one simulation on a CUDA tree: kernel A, the descent,
    the settle, the expansion's two kernels and the backup once each, and
    one evaluation."""
    return {"exact_top_k_unsorted": 1, "tree_descend": 1, "tree_settle": 1, "expand_mask": 1, "expand_store": 1,
            "tree_backup": 1,
            **per_evaluation(cfg)}


def _expect_launches(what: str, want: dict, count: int) -> dict:
    """Read the counters of the kernels that ``want`` names: each must have
    launched ``want[name] * count`` times.  Returns their counts."""
    got = _launches(*want)
    for name, n in got.items():
        if n != want[name] * count:
            raise AssertionError(f"{what}: {name} launched {n} times, expected {want[name]} x {count}")
    return got


def net_label(cfg) -> str:
    novelty = {"simhash": f"SimHash 2^{cfg.hash_bits}", "lcghash": f"LCG hash 2^{cfg.hash_bits}",
               "rnd": "MLP RND 800-1024-1024-512" if cfg.rnd_mlp else f"RND towers {cfg.rnd_blocks}x{cfg.rnd_filters}",
               "ensemble": f"{cfg.ensemble_size} ensemble heads", "none": "no novelty"}[cfg.novelty]
    return f"{cfg.blocks}x{cfg.filters} {str(cfg.compute_dtype).split('.')[-1]}, {novelty}"


def check_target_lines(eng, text: str, what: str) -> int:
    """Every line parses; every policy lists exactly the legal actions of
    its TPS; every value, UBE and probability is finite.  Returns the count."""
    import numpy as np
    import torch

    from takzero_torch.data.native_loader import parse_targets

    lines = text.count("\n")
    states, value, ube, actions, probs, offsets = parse_targets(eng.n, text)
    if len(value) != lines:
        raise AssertionError(f"{what}: the parser rejects {lines - len(value)} of {lines} lines")
    if not (np.isfinite(value).all() and np.isfinite(ube).all() and np.isfinite(probs).all()):
        raise AssertionError(f"{what}: non-finite value, UBE or probability")
    legal = eng.legal_mask(states)
    row = torch.from_numpy(np.repeat(np.arange(len(value)), np.diff(offsets)))
    listed = torch.zeros_like(legal)
    listed[row, torch.from_numpy(actions.astype(np.int64))] = True
    counts = torch.from_numpy(np.diff(offsets))
    bad = (listed != legal).any(-1) | (counts != legal.sum(-1))
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} policies do not list exactly the legal actions")
    return lines


def check_replays(eng, lines: list, what: str) -> int:
    """Every replay replays on the port's engine through ongoing positions to
    its recorded result (replays without a result stop early and are
    checked as ongoing).  Returns the count."""
    import numpy as np
    import torch

    from takzero_torch.data.native_loader import parse_replay_positions
    from takzero_torch.data.target import Replay, result_str_from

    replays = [Replay.from_line(eng.n, line) for line in lines]
    states, _ = parse_replay_positions(eng.n, eng.half_komi, eng.reversible_limit, "\n".join(lines) + "\n")
    lengths = np.array([len(r.actions) for r in replays])
    if len(states.ply) != lengths.sum():
        raise AssertionError(f"{what}: {lengths.sum()} moves but {len(states.ply)} positions")
    if bool((eng.terminal_kind(states) != 0).any()):
        raise AssertionError(f"{what}: a game went on past its end")
    last = torch.from_numpy(np.cumsum(lengths) - 1)
    final = eng.step(states.map(lambda x: x[last]), torch.tensor([r.actions[-1] for r in replays]))
    res, roads = eng.game_result(final).tolist(), eng._roads(final).tolist()
    for r, g, road in zip(replays, res, roads):
        want = "" if g == -1 else result_str_from(g, road[g] if g in (0, 1) else False)
        if want != r.result:
            raise AssertionError(f"{what}: replay ends in {want!r}, recorded {r.result!r}: {r.to_line()}")
    return len(replays)


def keep_run_files(d, keep, tag: str) -> None:
    """Copy a run's replays and targets to ``keep`` as ``{tag}_replays.txt``,
    ``{tag}_targets-selfplay.txt`` and ``{tag}_targets-reanalyze.txt``
    (phase 14 reads them after the run's directory is gone)."""
    import shutil

    from takzero_torch.parallel import coordinator as co

    for name in (co.REPLAYS, co.TARGETS_SELFPLAY, co.TARGETS_REANALYZE):
        shutil.copy(Path(d, name), Path(keep, f"{tag}_{name}"))


def run_actor_loop(dev, net: str = "net4_simhash", batch: int = 128, sampled: int = 8, budget: int = 24,
                   games: int = 64, keep=None) -> dict:
    """The actor-learner loop through the three drivers in one directory.

    Any preset: kernel B must launch (budget+1) per search on a SimHash net
    and never on another; a hash net's actors must hold the seen-set of the
    whole hash log, other nets must write none; an RND net's learner must
    refresh its bounds (min < max, finite) at the start of each run, and
    the actor's poller must load them.  ``keep``: a directory that receives
    the run's replays and targets (:func:`keep_run_files`, tag ``loop``)."""
    import json
    import math
    import tempfile

    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.data.native_loader import make_batch_native
    from takzero_torch.drivers import learn, reanalyze, selfplay
    from takzero_torch.models.agent import new_agent
    from takzero_torch.ops.bitset import bitset_init, bitset_set
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.tak.engine import engine
    from takzero_torch.train.learner import make_optimizer, make_train_step
    from takzero_torch.utils import ckpt

    t_phase = time.perf_counter()
    cfg = NET_PRESETS[net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    per_move = budget + 1
    per_sim = per_simulation(cfg)
    hashed = cfg.novelty in ("simhash", "lcghash")
    b_in_phase = 0  # kernel B's launches over the whole phase

    def zero_counts():
        nonlocal b_in_phase
        b_in_phase += launch_counts()["simhash_pack"]
        zero_launches()

    zero_launches()  # earlier phases' launches are not this phase's
    with tempfile.TemporaryDirectory(prefix="takzero_loop_") as d:
        common = ["--directory", d, "--net", net, "--device", str(dev)]
        search = ["--batch", str(batch), "--sampled", str(sampled), "--budget", str(budget)]
        learner = common + ["--batch-size", str(batch), "--no-wait"]
        torch.cuda.reset_peak_memory_stats(dev)
        # 1. Pre-training publishes model_latest.ckpt and hash_log.bin.
        pre = learn.main(learner + ["--seed", "0", "--pretrain-targets", str(10 * batch), "--pretrain-steps",
                                    "10", "--max-steps", "0"])
        # 2. Selfplay until `games` games have finished.
        zero_counts()
        sp = selfplay.main(common + search + ["--seed", "1", "--max-games", str(games)])
        del sp["agent"]
        sp_launches = _expect_launches("selfplay driver", per_sim, per_move * sp["moves"])
        # 3. Ten learner steps on the selfplay targets.
        lr = learn.main(learner + ["--seed", "2", "--pretrain-steps", "0", "--max-steps", "10"])
        if lr["steps"] != 10:
            raise AssertionError(f"the learner took {lr['steps']} steps on selfplay targets, expected 10")
        # 4. Two more moves: one reload, and the seen-set of the whole log.
        zero_counts()
        sp2 = selfplay.main(common + search + ["--seed", "3", "--max-steps", "2"])
        _expect_launches("selfplay driver, 2 moves", per_sim, per_move * 2)
        if sp2["reloads"] != 1:
            raise AssertionError(f"the selfplay poller reloaded {sp2['reloads']} times, expected 1")
        if hashed:
            idx, _ = ckpt.read_hash_indices(f"{d}/{ckpt.HASH_LOG}", 0)
            seen = bitset_set(bitset_init(cfg.hash_bits, dev), torch.from_numpy(idx.astype(np.int64)).to(dev))
            if not torch.equal(seen, sp2["agent"]["hash_bits"]):
                raise AssertionError("the selfplay actor's seen-set differs from bitset_set of hash_log.bin")
            del seen
        elif Path(d, ckpt.HASH_LOG).exists():
            raise AssertionError(f"{net}: hash_log.bin written for a net without a hash")
        rnd = None
        if cfg.novelty == "rnd":
            latest = ckpt.read_checkpoint(ckpt.latest_path(d))
            if not {"rnd", "rnd_min", "rnd_max"} <= set(latest):
                raise AssertionError(f"model_latest.ckpt lacks the RND keys: {sorted(latest)}")
            refreshes = pre["rnd_refreshes"] + lr["rnd_refreshes"]
            if len(refreshes) != 2 or not all(math.isfinite(lo) and math.isfinite(hi) and lo < hi
                                              for _, lo, hi in refreshes):
                raise AssertionError(f"RND refreshes {refreshes}: one per learner run, min < max, finite")
            bounds = [float(sp2["agent"][k]) for k in ("rnd_min", "rnd_max")]
            if bounds != list(refreshes[-1][1:]) or bounds != [float(latest[k]) for k in ("rnd_min", "rnd_max")]:
                raise AssertionError(f"the actor holds RND bounds {bounds}, the learner refreshed {refreshes[-1]}")
            rnd = {"refreshes": refreshes, "actor_bounds": bounds}
            del latest
        sp2_replays = sp2["replays"]
        del sp2
        # 5. Two reanalyze steps on the exploded replays.
        zero_counts()
        re = reanalyze.main(common + search + ["--seed", "4", "--min-positions", str(batch), "--max-steps", "2"])
        re_launches = _expect_launches("reanalyze", per_sim, per_move * re["steps"])
        if re["steps"] != 2 or re["targets"] != 2 * batch:
            raise AssertionError(f"reanalyze: {re['steps']} steps and {re['targets']} targets")
        # 6. One train step on reanalyze targets (the learner mixes them in
        # only after step 5,000).
        re_text = open(f"{d}/{co.TARGETS_REANALYZE}", encoding="utf-8").read()
        agent = ckpt.load_checkpoint(ckpt.latest_path(d), new_agent(cfg, seed=5, device=dev))
        first = "\n".join(re_text.splitlines()[:batch]) + "\n"
        batch_re = make_batch_native(eng, first, np.random.default_rng(0), device=dev)
        m = {k: float(v) for k, v in make_train_step(cfg)(agent, make_optimizer(agent), batch_re, True).items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        # The files: lines, policies, replays, losses.
        sp_lines = check_target_lines(eng, open(f"{d}/{co.TARGETS_SELFPLAY}", encoding="utf-8").read(),
                                      "targets-selfplay.txt")
        re_lines = check_target_lines(eng, re_text, "targets-reanalyze.txt")
        replays = open(f"{d}/{co.REPLAYS}", encoding="utf-8").read().splitlines()
        n_replays = check_replays(eng, replays, "replays.txt")
        rows = [json.loads(x) for x in open(f"{d}/metrics.jsonl", encoding="utf-8").read().splitlines()]
        keys = ("loss", "loss_policy", "loss_value", "loss_ube") + (("loss_rnd",) if cfg.novelty == "rnd" else ())
        losses = [r[k] for r in rows for k in keys] + list(m.values())
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("non-finite loss on the loop")
        zero_counts()
        if cfg.novelty != "simhash" and b_in_phase:
            raise AssertionError(f"{net}: kernel B launched {b_in_phase} times in the phase, expected 0")
        if n_replays != sp["replays"] + sp2_replays or sp["replays"] < games:
            raise AssertionError(f"{n_replays} replays in the file, the drivers finished "
                                 f"{sp['replays']} + {sp2_replays} games (at least {games} expected)")
        if keep is not None:
            keep_run_files(d, keep, "loop")

    out = {
        "phase": "actor-learner loop", "card": card_line(), "net": f"{net} ({net_label(cfg)})",
        "cuts": {"batch": batch, "sampled": sampled, "budget": budget, "pretrain_targets": 10 * batch,
                 "pretrain_steps": 10, "learner_steps": 10, "reanalyze_steps": 2},
        "selfplay": {"moves": sp["moves"], "games": sp["replays"], "targets": sp["targets"],
                     "moves_per_s": sp["moves"] / sp["seconds"], "targets_per_s": sp["targets"] / sp["seconds"],
                     "host_half_share": sp["host_seconds"] / sp["seconds"],
                     "write_share": sp["write_seconds"] / sp["seconds"], "seconds": sp["seconds"]},
        "reanalyze": {"steps": re["steps"], "targets": re["targets"], "positions": re["positions"],
                      "targets_per_s": re["targets"] / re["seconds"],
                      "explosion_share": re["explode_seconds"] / re["seconds"],
                      "host_share": re["host_seconds"] / re["seconds"], "seconds": re["seconds"]},
        "learner_on_selfplay_targets": {"steps_per_s": lr["steps"] / lr["seconds"],
                                        "host_assembly_share": lr["assemble_seconds"] / lr["seconds"]},
        "reanalyze_train_step": m, "lines_checked": {"selfplay": sp_lines, "reanalyze": re_lines,
                                                     "replays": n_replays},
        "launches": {"selfplay_driver": sp_launches, "reanalyze": re_launches, "per_move_or_step": per_move},
        "kernel_b_launches_in_phase": b_in_phase, "rnd": rnd,
        "peak_memory_gb": peak_gb, "seconds": time.perf_counter() - t_phase,
    }
    log(out)
    return out


# ---------------------------------------------------------------------------
# Phase 10: the serve path.
# ---------------------------------------------------------------------------

# The Elo tooling's patterns for the evaluation driver's log lines
# (takzero_tpu/tools/elo_curve.py:48, takzero_tpu/tools/match_results.py:16).
ELO_MATCH = re.compile(r"INFO:evaluation:(\S+) vs\. (\S+): Evaluation")
MATCH_RESULT = re.compile(
    r"([\w\-]+?)[_\-](\d+)\.(?:ot|ckpt) vs\. ([\w\-]+?)[_\-](\d+)\.(?:ot|ckpt): "
    r"Evaluation \{ wins: (\d+), losses: (\d+), draws: (\d+) \}"
)
INFO_LINE = re.compile(r"info time (\d+) nodes (\d+) nps (\d+) score (cp -?\d+|mate -?\d+) pv((?: \S+)+)")

# The repository's 6x6 puzzle database (238 puzzles: tinue at depths
# 3/5/7/9, avoidance at 2/4/6; examples/puzzle_benchmark_6x6.json holds the
# JAX package's results on it).
PUZZLE_DB = Path(__file__).resolve().parent / "examples" / "puzzles_6x6.db"
PUZZLE_COUNTS = {("tinue", 3): 50, ("tinue", 5): 20, ("tinue", 7): 20, ("tinue", 9): 10,
                 ("avoidance", 2): 41, ("avoidance", 4): 38, ("avoidance", 6): 59}


@contextlib.contextmanager
def recording_kernel_inputs(calls: list, last: int | None = None):
    """Record (kernel, input copy, k or matrix, host time) of every kernel
    call the search (A) and the evaluator (B) make, or of the ``last`` most
    recent ones; the calls still launch."""
    import takzero_torch.models.agent as agent
    import takzero_torch.search.core as core
    from takzero_torch.ops import simhash, topk

    def record(kernel, x, arg):
        calls.append((kernel, x.clone(), arg, time.perf_counter()))
        if last is not None:
            del calls[:-last]

    def rec_a(x, k):
        record("A", x, k)
        return topk.exact_top_k_unsorted(x, k)

    def rec_b(x, m):
        record("B", x, m)
        return simhash.simhash_pack(x, m)

    # The serve chunk takes its top-k from core's make_topk too.
    saved = core.exact_top_k_unsorted, agent.simhash_pack
    core.exact_top_k_unsorted, agent.simhash_pack = rec_a, rec_b
    try:
        yield
    finally:
        core.exact_top_k_unsorted, agent.simhash_pack = saved


def midgame_tps(eng, gen, dev, plies: int = 24) -> str:
    """TPS of a non-terminal 6x6 position after ``plies`` random plies."""
    import torch

    from takzero_torch.tak.tps import state_to_tps

    while True:
        state = eng.initial(1, dev)
        for _ in range(plies):
            act = torch.multinomial(eng.legal_mask(state).float(), 1, generator=gen)[:, 0]
            state = eng.step(state, act)
            if int(eng.terminal_kind(state)[0]):
                break
        else:
            return state_to_tps(eng.n, state.map(lambda x: x[0].cpu()))


def check_serve_kernels(engine_, tps: str, dev) -> dict:
    """10a: one TEI chunk at net6_simhash from ``tps`` with both kernels'
    inputs recorded; each kernel held against its plain version on them and
    timed at the serve chunk's shape."""
    import torch

    from takzero_torch.drivers.tei import MAX_NODES
    from takzero_torch.ops import simhash, topk
    from takzero_torch.search.tree import init_tree

    engine_.handle(f"position tps {tps}")
    tree = init_tree(engine_.eng, engine_.position, MAX_NODES, 256)
    calls = []
    with recording_kernel_inputs(calls):
        engine_._run(tree)
    torch.cuda.synchronize()
    a_in = [(x, k) for w, x, k, _ in calls if w == "A"]
    b_in = [(x, m) for w, x, m, _ in calls if w == "B"]
    shapes = {"A": [list(x.shape) for x, _ in a_in], "B": [list(x.shape) for x, _ in b_in]}
    if shapes != {"A": [[1, 9036], [127, 9036]], "B": [[1, 1296], [127, 1296]]}:
        raise AssertionError(f"serve chunk kernel inputs {shapes}")
    for x, k in a_in:
        expect_topk_equal(x, k, f"serve chunk rows {list(x.shape)}")
    phases = tuple(f"serve_chunk.{p}" for p in "ABCD")
    chunk_profile = profile_device(lambda: engine_._run(tree), calls=1, ranges=phases)
    b_err = max(expect_simhash_equal(x, m, f"serve chunk planes {list(x.shape)}") for x, m in b_in)

    (x, k), (xb, m) = a_in[1], b_in[1]
    b, a = x.shape
    a_out = dict(shape=[b, a], k=k, max_abs_err=0.0, rows_fewer_than_k_legal=int(((x > NEG / 2).sum(-1) < k).sum()),
                 kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(x, k))[0],
                 call_ms=call_ms(lambda: topk.exact_top_k_unsorted(x, k)),
                 plain_ms=device_ms(lambda: topk.topk_plain(x, k))[0],
                 library_ms=device_ms(lambda: torch.topk(x, k, sorted=False))[0])
    a_out["bound_ms"], a_out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    bb, inp = xb.shape
    bits = m.shape[1]
    b_out = dict(shape=[bb, inp, bits], max_abs_err=b_err,
                 kernel_ms=device_ms(lambda: simhash.simhash_pack(xb, m))[0],
                 call_ms=call_ms(lambda: simhash.simhash_pack(xb, m)),
                 plain_ms=device_ms(lambda: simhash.simhash_plain(xb, m))[0], library_ms=None)
    b_out["bound_ms"], b_out["bound_by"] = bound_ms(bb * inp * 4 + inp * bits * 4 + bb * 8, 2 * bb * inp * bits)
    log({"phase": "serve: kernels at the serve chunk's shapes", "card": card_line(),
         "exact_top_k_unsorted": a_out, "simhash_pack": b_out, "tei_chunk_profile": chunk_profile})
    return {"exact_top_k_unsorted": a_out, "simhash_pack": b_out}


def run_tei(engine_, tps: str) -> dict:
    """10b: TeiEngine.handle on a short session at net6_simhash."""
    import torch

    from takzero_torch.drivers.tei import SIM_CHUNK
    from takzero_torch.tak.moves import ptn_to_action

    out, eng = engine_.out, engine_.eng
    mark = [len(out.getvalue().splitlines())]

    def lines_since() -> list:
        lines = out.getvalue().splitlines()
        new, mark[0] = lines[mark[0]:], len(lines)
        return new

    def go(cmd: str) -> tuple[str, list]:
        position = engine_.position
        if not engine_.handle(cmd):
            raise AssertionError(f"TEI: {cmd!r} ended the session")
        lines = lines_since()
        infos = []
        for i, line in enumerate(lines[:-1]):
            m = INFO_LINE.fullmatch(line)
            if not m or int(m[2]) != SIM_CHUNK * (i + 1):
                raise AssertionError(f"TEI: {cmd!r}: info line {line!r} does not parse")
            for mv in m[5].split():
                ptn_to_action(eng.n, mv)
            infos.append({"time_ms": int(m[1]), "nodes": int(m[2]), "nps": int(m[3]), "score": m[4],
                          "pv": m[5].split()})
        best = lines[-1].split()
        if best[0] != "bestmove" or not infos:
            raise AssertionError(f"TEI: {cmd!r} answered {lines[-1]!r} after {len(infos)} info lines")
        if not bool(eng.legal_mask(position)[0, ptn_to_action(eng.n, best[1])]):
            raise AssertionError(f"TEI: bestmove {best[1]} is not legal")
        return best[1], infos

    zero_launches()
    t0 = time.perf_counter()
    for cmd, want in (("tei", "teiok"), ("isready", "readyok")):
        engine_.handle(cmd)
        if lines_since()[-1] != want:
            raise AssertionError(f"TEI: {cmd!r} not answered with {want!r}")
    engine_.handle("position startpos")
    best1, infos1 = go("go nodes 1024")
    root = engine_.tree
    slot = (root.child_action[0, 0] == ptn_to_action(eng.n, best1)).nonzero()[0, 0]
    child_visits, child_node = int(root.child_visit[0, 0, slot]), int(root.child_node[0, 0, slot])
    engine_.handle(f"position startpos moves {best1}")
    if engine_.tree is None:
        raise AssertionError(f"TEI: the descent to {best1} returned ok False (child node {child_node})")
    reused = int(engine_.tree.root_visit[0])
    if reused < child_visits:
        raise AssertionError(f"TEI: the reused root has {reused} visits, the child had {child_visits}")
    best2, infos2 = go("go nodes 1024")
    engine_.handle(f"position tps {tps}")
    best3, infos3 = go("go movetime 2000")
    if engine_.handle("quit"):
        raise AssertionError("TEI: quit did not end the session")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    chunks = len(infos1) + len(infos2) + len(infos3)
    # A chunk: one plain simulation (a descent, a settle, an expansion, a
    # backup) and the serve chunk, whose wavefront has its own loops; an
    # evaluation each.
    want = {name: 2 * n for name, n in per_simulation(engine_.cfg).items()}
    launches = _expect_launches("TEI", {**want, "tree_descend": 1, "tree_settle": 1, "expand_mask": 1,
                                        "expand_store": 1, "tree_backup": 1}, chunks)
    out = {"phase": "serve: TEI session", "net": "net6_simhash (16x256 bf16, SimHash 2^32)", "card": card_line(),
           "chunks": chunks, "sims_per_chunk": SIM_CHUNK, "bestmoves": [best1, best2, best3],
           "reused_root_visits": reused, "child_visits_before": child_visits,
           "nps_by_go": [i[-1]["nps"] for i in (infos1, infos2, infos3)],
           "nodes_by_go": [i[-1]["nodes"] for i in (infos1, infos2, infos3)],
           "seconds_per_chunk_last_go": infos3[-1]["time_ms"] / 1e3 / len(infos3),
           "last_info": infos3[-1], "launches": launches, "seconds": seconds}
    log(out)
    return out


def run_serve_bench(dev, tei: dict) -> dict:
    """10c: ``serve_bench`` with its defaults, beside TEI's own nps."""
    import torch

    from takzero_torch import serve_bench

    before = torch.cuda.memory_allocated(dev)  # the TEI engine's agent and tree stay allocated
    torch.cuda.reset_peak_memory_stats(dev)
    res = serve_bench.main(["--device", str(dev)])  # its defaults, on this card
    out = {"phase": "serve: serve_bench", "card": card_line(), **res,
           "config": "net6_simhash, 1 warm-up + 8 timed chunks of 1 simulate + 127-leaf serve chunk, 4096 rows, C=128",
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "allocated_before_gb": before / 1e9,
           "tei_nps_c256": tei["nps_by_go"]}
    log(out)
    return out


def run_analysis(engine_, tps: str, dev) -> dict:
    """10d: one analysis chunk at net6_simhash on a fresh tree."""
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import analysis
    from takzero_torch.tak.tps import tps_to_state

    cfg = NET_PRESETS["net6_simhash"]
    eng = engine_.eng
    run = analysis.make_chunk_runner(cfg, eng, engine_.bundle, dev)
    tree = analysis.fresh_tree(cfg, eng, tps_to_state(eng.n, tps).map(lambda x: x[None].to(dev)))
    zero_launches()
    t0 = time.perf_counter()
    tree = run(tree)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    # One simulation, then simulate_batch: a descent, a settle and an
    # expansion a simulation, and a backup of its known stops and one of its
    # leaves a batched one; two evaluations.
    want = {"exact_top_k_unsorted": analysis.SIM_CHUNK, "simhash_pack": 2, "tree_descend": analysis.SIM_CHUNK,
            "tree_settle": analysis.SIM_CHUNK, "expand_mask": analysis.SIM_CHUNK,
            "expand_store": analysis.SIM_CHUNK, "tree_backup": 2 * analysis.SIM_CHUNK - 1,
            "conv3x3": 2 * per_evaluation(cfg)["conv3x3"]}
    if launches != want:
        raise AssertionError(f"analysis chunk: launches {launches}, expected {want}")
    if int(tree.root_visit[0]) != analysis.SIM_CHUNK:
        raise AssertionError(f"analysis chunk: the root has {int(tree.root_visit[0])} visits")
    buf = io.StringIO()
    analysis.print_root_table(eng.n, tree, out=buf)
    rows = buf.getvalue().splitlines()[2:]
    valid = int((tree.child_action[0, 0] >= 0).sum())
    if len(rows) != valid:
        raise AssertionError(f"analysis table: {len(rows)} rows for {valid} valid root children")
    out = {"phase": "serve: analysis chunk", "card": card_line(), "root_children": valid,
           "seconds": seconds, "sims_per_s": analysis.SIM_CHUNK / seconds, "launches": launches,
           "top_rows": rows[:3]}
    log(out)
    return out


def run_evaluation(dev, games: int = 32, sampled: int = 4, budget: int = 8, max_moves: int = 25) -> dict:
    """10e: the evaluation driver with --pair at net4_simhash."""
    import logging

    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import evaluation
    from takzero_torch.models.agent import new_agent
    from takzero_torch.utils import ckpt

    cfg = NET_PRESETS["net4_simhash"]
    names = ["model_0000001.ckpt", "model_0000002.ckpt"]
    with tempfile.TemporaryDirectory(prefix="takzero_eval_") as d:
        for seed, name in zip((1, 2), names):
            ckpt.save_checkpoint(d, name, new_agent(cfg, seed=seed, device=dev))
        torch.cuda.empty_cache()
        buf = io.StringIO()
        handler = logging.StreamHandler(buf)
        handler.setFormatter(logging.Formatter("%(levelname)s:%(name)s:%(message)s"))
        logger = logging.getLogger("evaluation")
        logger.addHandler(handler)
        zero_launches()
        t0 = time.perf_counter()
        try:
            # --rss-limit-gb 0: the watchdog would outlive this phase in
            # the smoke's one process.
            results = evaluation.main([
                "--model-path", d, "--net", "net4_simhash", "--pair", ",".join(names), "--games", str(games),
                "--sampled", str(sampled), "--budget", str(budget), "--max-moves", str(max_moves),
                "--seed", "0", "--rss-limit-gb", "0", "--device", str(dev)])
        finally:
            logger.removeHandler(handler)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    half_moves = sum(r.half_moves for *_, r in results)
    launches = _expect_launches("evaluation driver", per_simulation(cfg), (budget + 1) * half_moves)
    lines = [x for x in buf.getvalue().splitlines() if " vs. " in x]
    if len(lines) != 2:
        raise AssertionError(f"evaluation driver: {len(lines)} match lines, expected 2")
    scores = []
    for line, (a, b, r) in zip(lines, results):
        m, res = ELO_MATCH.search(line), MATCH_RESULT.search(line)
        if not m or not res or m.groups() != (a, b):
            raise AssertionError(f"evaluation driver: the Elo tooling cannot parse {line!r}")
        wld = tuple(int(res[i]) for i in (5, 6, 7))
        if wld != (r.wins, r.losses, r.draws) or sum(wld) > games:
            raise AssertionError(f"evaluation driver: {line!r} against {r}")
        scores.append(list(wld))
    out = {"phase": "serve: evaluation driver", "card": card_line(),
           "net": "net4_simhash (16x256 bf16, SimHash 2^32)",
           "cuts": {"games": games, "sampled": sampled, "budget": budget, "max_moves": max_moves},
           "lines": lines, "wins_losses_draws": scores, "half_moves": half_moves,
           "half_moves_per_s": half_moves / seconds, "seconds": seconds, "launches": launches}
    log(out)
    return out


def run_puzzles(engine_, dev, sampled: int = 8, budget: int = 24) -> dict:
    """10f: the puzzle driver at net6_simhash on the repository's database,
    every category and depth, in batches of 64."""
    import math

    import torch

    from takzero_torch.drivers import puzzle
    from takzero_torch.utils import ckpt

    with tempfile.TemporaryDirectory(prefix="takzero_puzzle_") as d:
        model = ckpt.save_checkpoint(d, "model.ckpt", ckpt.strip_hash_bits(engine_.bundle))
        zero_launches()
        t0 = time.perf_counter()
        results = puzzle.main(["--model", str(model), "--puzzle-db", str(PUZZLE_DB), "--net", "net6_simhash",
                               "--depths", "3,5,7,9", "--avoidance-depths", "2,4,6",
                               "--sampled-actions", str(sampled), "--search-budget", str(budget),
                               "--device", str(dev)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    batches = sum(math.ceil(n / puzzle.BATCH_SIZE) for n in PUZZLE_COUNTS.values())
    launches = _expect_launches("puzzle driver", per_simulation(engine_.cfg), (budget + 1) * batches)
    got = [(r.category, r.attempted) for r in results]
    if got != [(c, n) for (c, _), n in PUZZLE_COUNTS.items()]:
        raise AssertionError(f"puzzle driver attempted {got}, the database holds {list(PUZZLE_COUNTS.values())}")
    per_depth = {f"{c}{d}": {"attempted": r.attempted, "solved": r.solved, "proven": r.proven, "nodes": r.nodes,
                             "nodes_incomplete": r.nodes_incomplete}
                 for (c, d), r in zip(PUZZLE_COUNTS, results)}
    out = {"phase": "serve: puzzle driver", "card": card_line(), "database": "examples/puzzles_6x6.db",
           "puzzles": sum(PUZZLE_COUNTS.values()), "batches": batches, "results": per_depth,
           "cuts": {"sampled": sampled, "budget": budget}, "seconds": seconds,
           "seconds_per_batch": seconds / batches, "launches": launches}
    log(out)
    return out


def run_serve_path(dev, gen) -> dict:
    """Phase 10: 10a-10f; returns each part's result."""
    import torch

    from takzero_torch.drivers.tei import TeiEngine
    from takzero_torch.tak.engine import engine

    t0 = time.perf_counter()
    tps = midgame_tps(engine(6, half_komi=4), gen, dev)
    engine_ = TeiEngine("net6_simhash", None, out=io.StringIO(), device=dev)
    engine_.handle("isready")
    res = {"kernels": check_serve_kernels(engine_, tps, dev)}
    res["tei"] = run_tei(engine_, tps)
    res["bench"] = run_serve_bench(dev, res["tei"])
    res["analysis"] = run_analysis(engine_, tps, dev)
    res["evaluation"] = run_evaluation(dev)
    res["puzzles"] = run_puzzles(engine_, dev)
    del engine_
    torch.cuda.empty_cache()
    log({"phase": "serve path done", "midgame_tps": tps, "seconds": time.perf_counter() - t0})
    return res


# ---------------------------------------------------------------------------
# Phases 11-12: one-process training.
# ---------------------------------------------------------------------------


class _CountingDraws:
    """The co-scheduled driver's own draws (one generator, the same order),
    reading the launch counters as each move takes its draws: ``snaps``
    holds (counters, reanalyze batches of the move before) per move."""

    def __init__(self, gen):
        from takzero_torch.drivers.coscheduled import GeneratorDraws

        self.inner, self.snaps, self.searches = GeneratorDraws(gen), [], 0

    def opening(self, batch: int, children: int) -> dict:
        return self.inner.opening(batch, children)

    def mark(self) -> None:
        """Close the move before (with its reanalyze batches); open one."""
        if self.snaps:
            self.snaps[-1] = (self.snaps[-1][0], self.searches)
        self.snaps.append((_launches(*AB), 0))
        self.searches = 0

    def move(self, batch: int, children: int) -> dict:
        self.mark()
        return self.inner.move(batch, children)

    def search(self, batch: int, children: int):
        self.searches += 1
        return self.inner.search(batch, children)


def run_coscheduled(dev, net: str = "net4_simhash", batch: int = 128, sampled: int = 8, budget: int = 24,
                    moves: int = 52, min_positions: int = 2048, keep=None) -> dict:
    """11: ``takzero_torch.drivers.coscheduled`` at full width with reanalyze
    (``keep``: as :func:`run_actor_loop`'s, tag ``cosched``)."""
    import math

    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import coscheduled
    from takzero_torch.ops.bitset import bitset_init, bitset_set
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.tak.engine import engine
    from takzero_torch.utils import ckpt

    t_phase = time.perf_counter()
    cfg = NET_PRESETS[net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    per = budget + 1
    with tempfile.TemporaryDirectory(prefix="takzero_cosched_") as d:
        argv = ["--directory", d, "--net", net, "--seed", "0", "--batch", str(batch), "--budget", str(budget),
                "--sampled", str(sampled), "--batch-size", str(batch), "--reanalyze",
                "--reanalyze-min-positions", str(min_positions), "--reanalyze-batch", str(batch),
                "--steps-before-reanalyze", "12", "--pretrain-steps", "10", "--pretrain-targets", str(10 * batch),
                "--max-moves", str(moves), "--device", str(dev)]
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        draws = _CountingDraws(torch.Generator(device=dev).manual_seed(0))
        out = coscheduled.main(argv, draws=draws)
        torch.cuda.synchronize()
        launches = _launches(*AB)
        draws.mark()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        agent = out.pop("agent")
        searches = out["moves"] + out["reanalyze_batches"]
        want = {"exact_top_k_unsorted": per * searches,
                "simhash_pack": per * searches + 2 * (out["pretrain_steps"] + out["train_steps"])}
        if launches != want:
            raise AssertionError(f"coscheduled: launches {launches}, expected {want} (budget+1 per search of "
                                 f"{searches}, B 2 per train step)")
        # Each move, from its draws to the next move's: the search, the
        # reanalyze batches it ran and its train steps.
        per_move = [({k: b[k] - a[k] for k in a}, n) for (a, n), (b, _) in zip(draws.snaps, draws.snaps[1:])]
        bad = [i for i, (m, n) in enumerate(per_move) if m["exact_top_k_unsorted"] != per * (1 + n)]
        if len(per_move) != out["moves"] or bad:
            raise AssertionError(f"coscheduled: moves {bad} launched A other than {per} per search")
        if out["reanalyze_batches"] < 2 or out["mixed_steps"] < 2:
            raise AssertionError(f"coscheduled: {out['reanalyze_batches']} reanalyze batches and "
                                 f"{out['mixed_steps']} mixed steps, at least 2 of each expected")
        metrics = out["final_metrics"] or {}
        if out["nonfinite_steps"] or not metrics or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"coscheduled: non-finite losses ({out['nonfinite_steps']} steps, last {metrics})")
        text = lambda name: open(f"{d}/{name}", encoding="utf-8").read()  # noqa: E731
        lines = {"selfplay": check_target_lines(eng, text(co.TARGETS_SELFPLAY), "targets-selfplay.txt"),
                 "reanalyze": check_target_lines(eng, text(co.TARGETS_REANALYZE), "targets-reanalyze.txt"),
                 "initial": check_target_lines(eng, text(co.TARGETS_INITIAL), "targets-initial.txt"),
                 "replays": check_replays(eng, text(co.REPLAYS).splitlines(), "replays.txt")}
        if lines["selfplay"] != out["targets"] or lines["reanalyze"] != out["reanalyze_targets"]:
            raise AssertionError(f"coscheduled: {lines} lines in the files, the driver counted {out}")
        if lines["replays"] != out["replays"] or out["replays"] < batch:
            raise AssertionError(f"coscheduled: {lines['replays']} replays in the file, {out['replays']} counted, "
                                 f"at least {batch} games expected to end")
        if text(co.BUFFER_LENGTHS).count(",") != 2:
            raise AssertionError("coscheduled: buffer_lengths.txt is not written")
        step, path = ckpt.model_path_with_most_steps(d)
        first, last = ckpt.read_checkpoint(f"{d}/model_0000000.ckpt"), ckpt.read_checkpoint(path)
        if step != out["model_steps"] or all(torch.equal(first["net"][k], v) for k, v in last["net"].items()):
            raise AssertionError(f"coscheduled: step checkpoint {path} equals model_0000000.ckpt")
        if "hash_bits" in ckpt.read_checkpoint(ckpt.latest_path(d)):
            raise AssertionError("coscheduled: model_latest.ckpt holds the seen-set")
        if keep is not None:
            keep_run_files(d, keep, "cosched")
        idx, _ = ckpt.read_hash_indices(f"{d}/{ckpt.HASH_LOG}", 0)
        seen = bitset_set(bitset_init(cfg.hash_bits, dev), torch.from_numpy(idx.astype(np.int64)).to(dev))
        if not torch.equal(seen, agent["hash_bits"]) or not torch.equal(seen.cpu(), last["hash_bits"]):
            raise AssertionError("coscheduled: bitset_set of hash_log.bin differs from the in-process seen-set")
        del first, last, seen, agent
    torch.cuda.empty_cache()
    res = {
        "phase": "coscheduled driver", "card": card_line(),
        "net": f"{net} ({cfg.blocks}x{cfg.filters} {str(cfg.compute_dtype).split('.')[-1]}, SimHash 2^{cfg.hash_bits})",
        "cuts": {"batch": batch, "sampled": sampled, "budget": budget, "reanalyze_batch": batch,
                 "reanalyze_min_positions": min_positions, "steps_before_reanalyze": 12, "pretrain_steps": 10,
                 "pretrain_targets": 10 * batch, "max_moves": moves},
        **{k: out[k] for k in ("moves", "train_steps", "pretrain_steps", "mixed_steps", "reanalyze_batches",
                                "targets", "reanalyze_targets", "replays", "model_steps", "seconds")},
        "moves_per_s": out["moves"] / out["seconds"],
        "selfplay_moves_per_s": out["moves"] / out["selfplay_seconds"],
        "reanalyze_targets_per_s": out["reanalyze_targets"] / max(out["reanalyze_seconds"], 1e-9),
        "train_steps_per_s_host_enqueue": out["train_steps"] / max(out["train_seconds"], 1e-9),
        "train_steps_per_s_loop": out["train_steps"] / out["seconds"], "final_metrics": metrics,
        "lines_checked": lines, "launches": launches,
        "launches_per_move": per_move[-1][0], "reanalyze_batches_last_move": per_move[-1][1],
        "launches_per_move_range": {k: [min(m[k] for m, _ in per_move), max(m[k] for m, _ in per_move)]
                                    for k in launches},
        "peak_memory_gb": peak_gb, "phase_seconds": time.perf_counter() - t_phase,
    }
    log(res)
    return res


def run_tiny_run(dev, iters: int = 1, eval_games: int = 8) -> dict:
    """12: ``python -m takzero_torch.tiny_run`` at its defaults, cut to
    ``iters`` iterations and ``eval_games`` evaluation games: the summary
    parses, games = 2 x eval_games, the final loss is finite (no Elo gate:
    one iteration does not train a net)."""
    import math

    import torch

    from takzero_torch import tiny_run

    snaps = {}  # the counters after pre-training (-1) and after each iteration
    with tempfile.TemporaryDirectory(prefix="takzero_tiny_") as d:
        zero_launches()
        t0 = time.perf_counter()
        res = tiny_run.main(["--iters", str(iters), "--eval-games", str(eval_games), "--out", f"{d}/tiny_run.json",
                             "--device", str(dev)], on_iteration=lambda it: snaps.__setitem__(it, _launches(*AB)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches(*AB)
        summary = json.loads(Path(f"{d}/tiny_run.json").read_text(encoding="utf-8"))
    del res["agent"], res["initial_agent"]
    keys = {"wins", "losses", "draws", "games", "elo_gain", "final_loss", "wall_s", "card"}
    if set(summary) != keys or summary["games"] != 2 * eval_games:
        raise AssertionError(f"tiny_run summary: {summary}")
    if summary["final_loss"] is None or not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"tiny_run: final loss {summary['final_loss']}")
    per = 48 + 1  # tiny_run's budget
    searches = iters * 12 + res["eval_half_moves"]
    # B: every evaluation, and each train step's hash_update (tiny_run keeps no hash log).
    want = {"exact_top_k_unsorted": per * searches, "simhash_pack": per * searches + res["train_steps"]}
    if launches != want:
        raise AssertionError(f"tiny_run: launches {launches}, expected {want}")
    # One iteration (12 moves, 16 train steps), read from the counters around it.
    per_iter = {k: snaps[iters - 1][k] - snaps[iters - 2][k] for k in launches}
    if per_iter != {"exact_top_k_unsorted": 12 * per, "simhash_pack": 12 * per + 16}:
        raise AssertionError(f"tiny_run: {per_iter} launches in iteration {iters - 1}, expected {per} per move "
                             "of 12, plus B once per train step of 16")
    out = {"phase": "tiny_run", "card": card_line(), "cuts": {"iters": iters, "eval_games": eval_games},
           "summary": summary, "train_steps": res["train_steps"], "eval_half_moves": res["eval_half_moves"],
           "launches": launches, "launches_per_iteration": per_iter, "seconds": seconds}
    log(out)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the novelty variants (RND tower and MLP, LCG hash, ensemble).
# ---------------------------------------------------------------------------


def check_novelty_small_reference(dev) -> dict:
    """13a: each small configuration on the card against the CPU, from the
    same weights (``new_agent`` draws on the CPU), in float32 and bf16:
    LCG hash indices bit for bit, ``net_evaluate``'s outputs, two train
    steps (every metric, ``loss_rnd`` included), the RND bounds after a
    refresh from the same reference batches, the seen-sets; the RND
    target's weights and statistics unchanged on the card."""
    import dataclasses

    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.eee.harness import random_plane_batch
    from takzero_torch.models.agent import lcghash_indices, make_net_evaluate, new_agent, rnd_update_normalization
    from takzero_torch.models.network import NetConfig
    from takzero_torch.ops.repr import state_to_planes
    from takzero_torch.tak.engine import engine

    configs = {
        "tiny3_rnd": NET_PRESETS["tiny3_rnd"],
        "tiny4": NET_PRESETS["tiny4"],
        "net5_16x2": dataclasses.replace(NET_PRESETS["net5"], filters=16, blocks=2),  # the MLP at full width
        "ensemble_16x2": NetConfig(n=4, half_komi=4, filters=16, blocks=2, novelty="ensemble"),
    }
    report = {"phase": "novelty small reference", "card": card_line()}
    # Tolerances of the CPU tests and of phase 7: float32 1e-4 (summation
    # order; TF32 off); bf16 5e-2 on the evaluator's outputs and the train
    # steps' metrics, with every policy argmax but 5% equal.  In bf16 a
    # float32 sum within rounding of a bf16 boundary rounds the other way on
    # the other side, one bf16 step: 0.0156 at a logit of 2-4 (found: 2 of
    # 60,416 tiny4 logits off by 0.0126) and 0.03125 at 4-8.
    for name, base in configs.items():
        for dtype, tol, train_tol in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 5e-2, 5e-2)):
            cfg = dataclasses.replace(base, compute_dtype=dtype)
            where = f"{name} {str(dtype).split('.')[-1]}"
            eng = engine(cfg.n, half_komi=cfg.half_komi)
            envs = random_positions(eng, 64, 10, torch.Generator().manual_seed(4), "cpu")
            planes = state_to_planes(eng, envs)
            cpu, card = new_agent(cfg, seed=2, device="cpu"), new_agent(cfg, seed=2, device=dev)
            row = {}
            planes_card = state_to_planes(eng, envs.map(lambda t: t.to(dev)))
            if not torch.equal(planes_card.cpu().view(torch.int32), planes.view(torch.int32)):
                raise AssertionError(f"{where}: input planes differ between card and CPU")
            if cfg.novelty == "lcghash":
                want = lcghash_indices(cfg, cpu["hash_scale"], planes)
                got = lcghash_indices(cfg, card["hash_scale"], planes_card)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"{where}: LCG hash indices differ between card and CPU")
                row["lcghash_indices"] = "card == cpu, planes bit for bit"
            if cfg.novelty == "rnd":
                refs = [random_plane_batch(eng, torch.Generator().manual_seed(seed), ply, 32)
                        for seed, ply in ((9, 4), (10, 20))]
                rnd_update_normalization(cfg, cpu, *refs)
                rnd_update_normalization(cfg, card, *(r.to(dev) for r in refs))
            out_cpu = make_net_evaluate(cfg, eng, device="cpu")(cpu, envs)
            out_card = make_net_evaluate(cfg, eng, device=dev)(card, envs.map(lambda t: t.to(dev)))
            for g, w, what in zip(out_card, out_cpu, ("policy", "value", "variance")):
                torch.testing.assert_close(g.cpu(), w, rtol=tol, atol=tol, msg=lambda m: f"{where} {what}: {m}")
            agree = float((out_card[0].cpu().argmax(-1) == out_cpu[0].argmax(-1)).float().mean())
            if agree < 0.95:
                raise AssertionError(f"{where}: policy argmax agrees on {agree:.3f} of positions")
            var = out_card[2]
            if not bool(((var >= 0) & (var <= 4)).all()):
                raise AssertionError(f"{where}: variance outside [0, 4]")
            row["evaluate_max_abs_diff"] = max(float((g.cpu() - w).abs().max()) for g, w in zip(out_card, out_cpu))
            row["policy_argmax_agreement"] = agree
            (a_cpu, m_cpu), (a_card, m_card) = _train_pair(cfg, dev)
            worst = 0.0
            for mc, mg in zip(m_cpu, m_card):
                if set(mc) != set(mg) or (cfg.novelty == "rnd") != ("loss_rnd" in mc):
                    raise AssertionError(f"{where}: metrics {sorted(mg)} on the card, {sorted(mc)} on the CPU")
                for k in mc:
                    worst = max(worst, abs(mc[k] - mg[k]))
                    if not abs(mc[k] - mg[k]) <= train_tol * max(1.0, abs(mc[k])):
                        raise AssertionError(f"{where}: {k} {mg[k]} on the card, {mc[k]} on the CPU")
            row["train_metrics"] = m_card
            row["train_max_metric_diff"] = worst
            if "hash_bits" in a_cpu and not torch.equal(a_card["hash_bits"].cpu(), a_cpu["hash_bits"]):
                raise AssertionError(f"{where}: seen-sets differ between card and CPU after the train steps")
            if cfg.novelty == "rnd":
                rnd_update_normalization(cfg, a_cpu, *refs)
                rnd_update_normalization(cfg, a_card, *(r.to(dev) for r in refs))
                bounds = {k: (float(a_card[k]), float(a_cpu[k])) for k in ("rnd_min", "rnd_max")}
                for k, (g, w) in bounds.items():
                    if not abs(g - w) <= train_tol * max(1.0, abs(w)):
                        raise AssertionError(f"{where}: {k} {g} on the card, {w} on the CPU after the steps")
                fresh = new_agent(cfg, seed=2, device=dev)["rnd"].target.state_dict()
                for k, v in a_card["rnd"].target.state_dict().items():
                    if not torch.equal(v, fresh[k]):
                        raise AssertionError(f"{where}: the RND target's {k} changed in training")
                row["rnd_bounds_card_cpu"] = bounds
                row["rnd_target"] = "unchanged, bit for bit"
            report[where] = row
    log(report)
    return report


def run_lcghash_drivers(dev, batch: int = 128, sampled: int = 8, budget: int = 24) -> dict:
    """13c: ``drivers/learn.py`` and ``drivers/selfplay.py`` at net4_lcghash
    (16x256 bf16, LCG hash over a 2^32 seen-set): pre-training (1,280
    targets, 10 steps), 4 selfplay moves, 4 learner steps on random-game
    targets (a step checkpoint at 14), 2 more moves.  The hash log must
    hold each index once and exactly the learner's seen-set, the actor's
    seen-set must equal the learner's after its poll, kernel A must launch
    (budget+1) per move and kernel B never."""
    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import learn, selfplay
    from takzero_torch.ops.bitset import bitset_init, bitset_set
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.tak.engine import engine
    from takzero_torch.train.data import random_pretraining_targets
    from takzero_torch.utils import ckpt

    t_phase = time.perf_counter()
    net = "net4_lcghash"
    cfg = NET_PRESETS[net]
    per = budget + 1
    with tempfile.TemporaryDirectory(prefix="takzero_lcg_") as d:
        common = ["--directory", d, "--net", net, "--device", str(dev)]
        search = ["--batch", str(batch), "--sampled", str(sampled), "--budget", str(budget)]
        learner = common + ["--batch-size", str(batch), "--no-wait", "--steps-per-checkpoint", "14"]
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        learn.main(learner + ["--seed", "0", "--pretrain-targets", str(10 * batch), "--pretrain-steps", "10",
                              "--max-steps", "0"])
        _expect_launches("net4_lcghash learner pre-training", dict.fromkeys(launch_counts(), 0), 1)
        log_after_pre = ckpt.read_hash_indices(f"{d}/{ckpt.HASH_LOG}", 0)[0].size
        sp = selfplay.main(common + search + ["--seed", "1", "--max-steps", "4"])
        sp_launches = _expect_launches("net4_lcghash selfplay", per_simulation(cfg), per * 4)
        eng = engine(cfg.n, half_komi=cfg.half_komi)
        lines = [t.to_line() for t in random_pretraining_targets(eng, 4 * batch, np.random.default_rng(3), device=dev)]
        Path(d, co.TARGETS_SELFPLAY).write_text("\n".join(lines) + "\n", encoding="utf-8")
        zero_launches()
        lr = learn.main(learner + ["--seed", "2", "--pretrain-steps", "0", "--max-steps", "4"])
        _expect_launches("net4_lcghash learner", dict.fromkeys(launch_counts(), 0), 1)
        sp2 = selfplay.main(common + search + ["--seed", "3", "--max-steps", "2"])
        _expect_launches("net4_lcghash selfplay, 2 moves", per_simulation(cfg), per * 2)
        step14 = ckpt.read_checkpoint(f"{d}/model_0000014.ckpt")["hash_bits"].to(dev)
        idx, _ = ckpt.read_hash_indices(f"{d}/{ckpt.HASH_LOG}", 0)
        # Distinct indices that rebuild the learner's seen-set: the log
        # holds each set bit once and nothing else.
        if np.unique(idx).size != idx.size:
            raise AssertionError(f"hash_log.bin holds {idx.size - np.unique(idx).size} repeated indices")
        seen = bitset_set(bitset_init(cfg.hash_bits, dev), torch.from_numpy(idx.astype(np.int64)).to(dev))
        if not torch.equal(seen, step14):
            raise AssertionError("bitset_set of hash_log.bin differs from the learner's seen-set at step 14")
        del seen
        if sp2["reloads"] != 1 or not torch.equal(sp2["agent"]["hash_bits"], step14):
            raise AssertionError("the actor's seen-set after its poll differs from the learner's at step 14")
        if lr["steps"] != 4 or idx.size <= log_after_pre:
            raise AssertionError(f"learner: {lr['steps']} steps, the log grew {log_after_pre} -> {idx.size}")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        del step14, sp2
    torch.cuda.empty_cache()
    out = {"phase": "novelty: LCG hash drivers", "card": card_line(), "net": f"{net} ({net_label(cfg)})",
           "cuts": {"batch": batch, "sampled": sampled, "budget": budget, "pretrain_steps": 10,
                    "learner_steps": 4, "selfplay_moves": 6},
           "selfplay_moves_per_s": sp["moves"] / sp["seconds"], "learner_steps_per_s": lr["steps"] / lr["seconds"],
           "hash_log_indices": {"after_pretraining": log_after_pre, "final": int(idx.size)},
           "launches_per_move": {k: v // 4 for k, v in sp_launches.items()},
           "peak_memory_gb": peak_gb, "seconds": time.perf_counter() - t_phase}
    log(out)
    return out


def check_topk_5x5(gen, dev) -> dict:
    """Kernel A at net5's 5x5 shape, f32[128, 3075]: masked logits of random
    5x5 positions and the adversarial rows with k=1, 128 and A, values bit
    for bit and indices exactly; timed at k=128."""
    import torch

    from takzero_torch.ops import topk
    from takzero_torch.tak.engine import engine

    eng = engine(5, half_komi=4)
    legal = eng.legal_mask(random_positions(eng, 128, 30, gen, dev))
    b, a = legal.shape
    rows = torch.where(legal, torch.randn(b, a, generator=gen, device=dev), NEG).contiguous()
    hard = adversarial_rows(a, gen, dev)
    for k in (1, 128, a):
        expect_topk_equal(rows, k, f"5x5 masked logits k={k}")
        expect_topk_equal(hard, k, f"5x5 adversarial rows k={k}")
    k = 128
    out = dict(shape=[b, a], k=k, max_abs_err=0.0,
               kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(rows, k))[0],
               call_ms=call_ms(lambda: topk.exact_top_k_unsorted(rows, k)),
               plain_ms=device_ms(lambda: topk.topk_plain(rows, k))[0],
               library_ms=device_ms(lambda: torch.topk(rows, k, sorted=False))[0])
    out["bound_ms"], out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    log({"phase": "kernel A at 5x5 (net5)", "card": card_line(), **out})
    return out


def run_ensemble_and_net5(dev, batch: int = 128, sampled: int = 8, budget: int = 24) -> dict:
    """13d: net4_ensemble and net5 at full width through the drivers: the
    learner's pre-training (2 steps on 256 targets; the ensemble learner
    must warn that it leaves its heads untrained), one selfplay move each
    (kernel A (budget+1) launches, kernel B none), the variance in [0, 4]
    on random positions, and for net5 two learner steps on random-game
    targets (finite metrics, ``loss_rnd`` included)."""
    import logging
    import math

    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import learn, selfplay
    from takzero_torch.models.agent import make_net_evaluate
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.tak.engine import engine
    from takzero_torch.train.data import random_pretraining_targets

    per = budget + 1
    res = {}
    for net in ("net4_ensemble", "net5"):
        t0 = time.perf_counter()
        cfg = NET_PRESETS[net]
        warnings = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda record: warnings.append(record.getMessage())
        logging.getLogger("learn").addHandler(handler)
        with tempfile.TemporaryDirectory(prefix="takzero_nov_") as d:
            common = ["--directory", d, "--net", net, "--device", str(dev)]
            torch.cuda.reset_peak_memory_stats(dev)
            zero_launches()
            try:
                lr = learn.main(common + ["--batch-size", str(batch), "--no-wait", "--seed", "0",
                                          "--pretrain-targets", str(2 * batch), "--pretrain-steps", "2",
                                          "--max-steps", "0"])
            finally:
                logging.getLogger("learn").removeHandler(handler)
            _expect_launches(f"{net} learner", dict.fromkeys(launch_counts(), 0), 1)
            warned = any("NOT trained" in w for w in warnings)
            if warned != (cfg.novelty == "ensemble"):
                raise AssertionError(f"{net}: ensemble warning {'given' if warned else 'missing'}: {warnings}")
            sp = selfplay.main(common + ["--batch", str(batch), "--sampled", str(sampled), "--budget", str(budget),
                                         "--seed", "1", "--max-steps", "1"])
            # net4_ensemble's evaluations read the core through with_core.
            launches = _expect_launches(f"{net} selfplay move", per_simulation(cfg), per)
            if sp["reloads"] != 1:
                raise AssertionError(f"{net}: the selfplay poller reloaded {sp['reloads']} times, expected 1")
            eng = engine(cfg.n, half_komi=cfg.half_komi)
            envs = random_positions(eng, batch, 12, torch.Generator(device=dev).manual_seed(5), dev)
            _, value, var = make_net_evaluate(cfg, eng, device=dev)(sp["agent"], envs)
            steps = None
            if net == "net5":  # two learner steps on random-game targets
                lines = [t.to_line() for t in random_pretraining_targets(eng, 2 * batch, np.random.default_rng(3),
                                                                          device=dev)]
                Path(d, co.TARGETS_SELFPLAY).write_text("\n".join(lines) + "\n", encoding="utf-8")
                zero_launches()
                lr = learn.main(common + ["--batch-size", str(batch), "--no-wait", "--seed", "2",
                                          "--pretrain-steps", "0", "--max-steps", "2"])
                _expect_launches("net5 learner", dict.fromkeys(launch_counts(), 0), 1)
                rows = [json.loads(x) for x in Path(d, "metrics.jsonl").read_text(encoding="utf-8").splitlines()]
                if lr["steps"] != 2 or not all(math.isfinite(r[k]) for r in rows for k in r if k != "step"):
                    raise AssertionError(f"net5 learner: {lr['steps']} steps, metrics {rows}")
                steps = {"steps": 2, "steps_per_s": lr["steps"] / lr["seconds"], "loss_rnd": rows[-1]["loss_rnd"]}
            if not bool(((var >= 0) & (var <= 4)).all() & torch.isfinite(value).all()):
                raise AssertionError(f"{net}: variance outside [0, 4] or non-finite value")
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            del sp["agent"]
        res[net] = {"net": f"{net} ({net_label(cfg)})", "ensemble_warning": warned,
                    "learner_steps": steps, "moves_per_s": 1 / sp["seconds"], "launches_per_move": launches,
                    "variance_range": [float(var.min()), float(var.max())], "peak_memory_gb": peak_gb,
                    "seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    log({"phase": "novelty: ensemble and net5 drivers", "card": card_line(), **res})
    return res


# ---------------------------------------------------------------------------
# Phase 14: EEE and the visualizers.
# ---------------------------------------------------------------------------

def time_simhash(x, m) -> dict:
    """Kernel B at x's shape: device and call time, the plain version's and the bound."""
    from takzero_torch.ops import simhash

    b, inp = x.shape
    bits = m.shape[1]
    out = dict(shape=[b, inp, bits], kernel_ms=device_ms(lambda: simhash.simhash_pack(x, m))[0],
               call_ms=call_ms(lambda: simhash.simhash_pack(x, m)),
               plain_ms=device_ms(lambda: simhash.simhash_plain(x, m))[0], library_ms=None)
    out["bound_ms"], out["bound_by"] = bound_ms(b * inp * 4 + inp * bits * 4 + b * 8, 2 * b * inp * bits)
    return out


def _eee_rows_gate(rows, what: str, steps: int, lo: float = 0.0, hi: float | None = 4.0) -> None:
    import math

    if len(rows) != steps:
        raise AssertionError(f"{what}: {len(rows)} steps, expected {steps}")
    for m in rows:
        for k, v in m.items():
            if not math.isfinite(v) or (k not in ("loss", "loss_policy", "loss_value", "loss_ube", "loss_ensemble")
                                        and hi is not None and not lo <= v <= hi):
                raise AssertionError(f"{what}: {k} = {v}")


def _csv_gate(path, steps: int, what: str) -> None:
    from takzero_torch.eee.rnd import CSV_HEADER  # the reference's layout (rnd.rs:322-340)

    lines = Path(path).read_text(encoding="utf-8").splitlines()
    if lines[0] != CSV_HEADER or [int(x.split(",")[0]) for x in lines[1:]] != list(range(steps)):
        raise AssertionError(f"{what}: the CSV is not the reference's header and one row per step: {lines[:2]}")


def run_eee_generalization(dev, replays, out, steps: int = 20, lcg_steps: int = 3) -> dict:
    """14a: ``eee.generalization.run`` at its defaults (4x4, half-komi 4,
    batch 256) on phases 9 and 11's replays, SimHash over 2^26 bits for
    ``steps`` steps and the LCG hash for ``lcg_steps``: ``current`` 4.0 at
    step 0, ``after`` exactly 0.0 at every step, every value in [0, 4];
    kernel B 8 launches a SimHash step and none under the LCG hash; kernel
    B's words on the last step's planes equal ``simhash_plain``'s under
    phase 4's rule, and B timed at that shape."""
    import torch

    from takzero_torch.eee import generalization

    res = {}
    for novelty, n_steps in (("simhash", steps), ("lcghash", lcg_steps)):
        calls, report = [], {}
        csv = Path(out, f"eee_generalization_{novelty}.csv")
        zero_launches()
        t0 = time.perf_counter()
        with recording_kernel_inputs(calls, last=8), contextlib.redirect_stdout(io.StringIO()):
            rows = generalization.run(replays, csv, n=4, half_komi=4, novelty=novelty, hash_bits=26, steps=n_steps,
                                      batch_size=256, device=dev, report=report)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches(*AB)
        per_step = 8 if novelty == "simhash" else 0
        if launches != {"exact_top_k_unsorted": 0, "simhash_pack": per_step * n_steps}:
            raise AssertionError(f"EEE generalization ({novelty}): launches {launches}, expected B {per_step} a step")
        _eee_rows_gate(rows, f"EEE generalization ({novelty})", n_steps)
        if rows[0]["current"] != 4.0 or any(m["after"] != 0.0 for m in rows):
            raise AssertionError(f"EEE generalization ({novelty}): current {rows[0]['current']} at step 0, "
                                 f"after {[m['after'] for m in rows]}")
        _csv_gate(csv, n_steps, f"EEE generalization ({novelty})")
        res[novelty] = {"steps": n_steps, "seconds": seconds, "seconds_per_step": seconds / n_steps,
                        "launches": launches, "reference_batches": report["sources"],
                        "replay_positions": report["positions"], "first": rows[0], "last": rows[-1]}
        if novelty == "simhash":
            shapes = [(w, list(x.shape)) for w, x, _, _ in calls]
            if shapes != [("B", [256, 448])] * 8:
                raise AssertionError(f"EEE generalization: kernel B inputs {shapes} on the last step")
            err = max(expect_simhash_equal(x, m, f"EEE generalization step planes, call {i}")
                      for i, (_, x, m, _) in enumerate(calls))
            _, x, m, _ = calls[0]  # the training batch
            res["at_eee_generalization"] = {**time_simhash(x, m), "max_abs_err": err}
            del calls
    return res


def run_eee_rnd(dev, replays, out, steps: int = 20) -> dict:
    """14b: ``eee.rnd.run`` at its defaults (two 32x4 RND towers, bf16,
    batch 256) for ``steps`` steps: every metric finite, ``after <=
    current`` on the last step, the reference's CSV header; no kernel."""
    import torch

    from takzero_torch.eee import rnd

    report = {}
    csv = Path(out, "eee_rnd.csv")
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = rnd.run(replays, csv, n=4, half_komi=4, steps=steps, batch_size=256, device=dev, report=report)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _expect_launches("EEE rnd", dict.fromkeys(AB, 0), 1)
    _eee_rows_gate(rows, "EEE rnd", steps, hi=None)
    if not rows[-1]["after"] <= rows[-1]["current"]:
        raise AssertionError(f"EEE rnd: after {rows[-1]['after']} > current {rows[-1]['current']} on the last step")
    _csv_gate(csv, steps, "EEE rnd")
    return {"steps": steps, "seconds": seconds, "seconds_per_step": seconds / steps,
            "reference_batches": report["sources"], "replay_positions": report["positions"],
            "first": rows[0], "last": rows[-1]}


def check_ensemble_step_card_vs_cpu(dev, targets) -> dict:
    """14c, first: one ensemble step of a 16x2 net with 16 heads on the card
    against the same step on the CPU, from the same weights, batch and
    draws: float32 metrics within 1e-4, bf16 within 5e-2 (phase 13a's
    tolerances)."""
    import dataclasses

    import numpy as np
    import torch

    from takzero_torch.eee import ensemble
    from takzero_torch.eee.harness import random_plane_batch
    from takzero_torch.models.agent import new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak.engine import engine
    from takzero_torch.train.data import make_batch

    eng = engine(4, half_komi=4)
    picked = ensemble.read_targets(4, targets, 16)[:32]
    gumbel = gumbel_noise(torch.Generator().manual_seed(14), (len(picked), eng.num_actions))
    refs = {name: random_plane_batch(eng, torch.Generator().manual_seed(20 + i), ply, 32)
            for i, (name, ply) in enumerate(zip(("early", "late", "random_early", "random_late", "impossible_early"),
                                                (8, 60, 8, 60, 8)))}
    base = NetConfig(n=4, half_komi=4, filters=16, blocks=2, novelty="ensemble", ensemble_size=16)
    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        got = {}
        for where in ("cpu", dev):
            bundle = new_agent(cfg, seed=3, device=where)
            batch, states = make_batch(eng, picked, np.random.default_rng(5), return_states=True, device=where)
            step = ensemble.make_ensemble_step(cfg, eng)
            got[str(where)] = ensemble.to_floats(step(bundle, ensemble.make_ensemble_optimizer(bundle), batch, states,
                                                      gumbel.to(where), {k: v.to(where) for k, v in refs.items()}))
        cpu, card = got["cpu"], got[str(dev)]
        worst = max(abs(card[k] - v) / max(1.0, abs(v)) for k, v in cpu.items())
        if set(card) != set(cpu) or worst > tol:
            raise AssertionError(f"ensemble step 16x2 {dtype}: card {card}, CPU {cpu}")
        out[str(dtype).split(".")[-1]] = {"max_rel_diff": worst, "card": card}
    return out


def run_eee_ensemble(dev, targets, out, steps: int = 5) -> dict:
    """14c: ``eee.ensemble.run`` at its defaults (16x256 bf16, 16 heads,
    batch 128) for ``steps`` steps on phases 9 and 11's targets: the losses
    finite, ``loss_ensemble >= 0``, the variances in [0, 4]; no kernel."""
    import torch

    from takzero_torch.eee import ensemble

    report = {}
    csv = Path(out, "eee_ensemble.csv")
    zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = ensemble.run(targets, csv, n=4, half_komi=4, steps=steps, batch_size=128, device=dev, report=report)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _expect_launches("EEE ensemble", dict.fromkeys(AB, 0), 1)
    _eee_rows_gate(rows, "EEE ensemble", steps)
    if not all(m["loss_ensemble"] >= 0 for m in rows):
        raise AssertionError(f"EEE ensemble: a negative ensemble loss in {rows}")
    _csv_gate(csv, steps, "EEE ensemble")
    return {"steps": steps, "seconds": seconds, "seconds_per_step": seconds / steps, "targets": report["targets"],
            "reference_batches": report["sources"], "first": rows[0], "last": rows[-1],
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def run_seen_ratio(dev, out, plies: int = 16, batch: int = 65_536, small: int = 512) -> dict:
    """14d: ``drivers/eee.py seen-ratio`` at net6_simhash (SimHash over
    2^32 bits), batch 65,536, plies 0 to ``plies``-1, on the step
    checkpoint of a short learner pre-training (640 random-game targets, 5
    steps): every ratio in [0, 1], kernel B once a ply; its words on the
    last ply's 65,536 rows equal ``simhash_plain``'s under phase 4's rule
    (rows with a near-zero dot counted), B timed at that shape; seconds per
    ply and peak device memory, and the games of ply 8 under the profiler;
    then the card's ratios at batch ``small`` equal the CPU's from the same
    draws."""
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import eee, learn
    from takzero_torch.eee import seen_ratio
    from takzero_torch.eee.harness import random_draws, random_planes
    from takzero_torch.models.agent import new_agent
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak.engine import engine
    from takzero_torch.utils import ckpt

    cfg = NET_PRESETS["net6_simhash"]
    with tempfile.TemporaryDirectory(prefix="takzero_seen_") as d:
        learn.main(["--directory", d, "--net", "net6_simhash", "--device", str(dev), "--batch-size", "128",
                    "--no-wait", "--seed", "0", "--pretrain-targets", "640", "--pretrain-steps", "5",
                    "--max-steps", "0"])
        _, model = ckpt.model_path_with_most_steps(d)
        torch.cuda.empty_cache()
        calls = []
        zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with recording_kernel_inputs(calls, last=2), contextlib.redirect_stdout(io.StringIO()):
            pairs = eee.main(["seen-ratio", "--model", str(model), "--net", "net6_simhash", "--max-ply", str(plies),
                              "--batch", str(batch), "--device", str(dev), "--csv", str(Path(out, "seen_ratio.csv"))])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        launches = _launches(*AB)
        if launches != {"exact_top_k_unsorted": 0, "simhash_pack": plies}:
            raise AssertionError(f"seen-ratio: launches {launches}, expected B once per ply of {plies}")
        if [p for p, _ in pairs] != list(range(plies)) or not all(0.0 <= r <= 1.0 for _, r in pairs):
            raise AssertionError(f"seen-ratio: ratios {pairs}")
        (_, _, _, t_prev), (_, x, m, t_last) = calls
        if list(x.shape) != [batch, 1296] or m.shape[1] != cfg.hash_bits:
            raise AssertionError(f"seen-ratio: kernel B input {list(x.shape)} x {list(m.shape)}")
        err = expect_simhash_equal(x, m, f"seen-ratio ply {plies - 1}, {batch} rows")
        near_zero_rows = int(((x.double() @ m.double()).abs() <= 1e-4).any(-1).sum())
        at_seen = {**time_simhash(x, m), "max_abs_err": err, "near_zero_rows": near_zero_rows}
        del calls, x
        # Where a ply's time goes: the games of ply 8 (8 random plies) under the profiler.
        eng = engine(cfg.n, half_komi=cfg.half_komi)
        ply8 = profile_device(lambda: random_planes(eng, 8, **random_draws(
            seen_ratio.ply_generator(123, 8, dev), batch, eng.num_actions)), calls=1)

        # Batch `small`, the card against the CPU from the same draws.
        a = eng.num_actions

        def draws_on(where):
            def draws(ply):
                g = torch.Generator().manual_seed(1000 + ply)
                d = {"sym": torch.randint(0, 8, (small,), generator=g), "pair": torch.randint(0, 2, (small,), generator=g),
                     "gumbel": gumbel_noise(g, (ply, small, a))}
                return {k: v.to(where) for k, v in d.items()}
            return draws

        ratios = {}
        for where in ("cpu", dev):
            bundle = ckpt.load_checkpoint(model, new_agent(cfg, seed=0, device=where))
            with contextlib.redirect_stdout(io.StringIO()):
                ratios[str(where)] = seen_ratio.run(bundle, cfg, max_ply=plies, batch=small, device=where,
                                                    draws=draws_on(where))
            del bundle
        if ratios[str(dev)] != ratios["cpu"]:
            raise AssertionError(f"seen-ratio at batch {small}: card {ratios[str(dev)]}, CPU {ratios['cpu']}")
    torch.cuda.empty_cache()
    return {"net": f"net6_simhash ({net_label(cfg)})", "batch": batch, "plies": plies, "ratios": pairs,
            "seconds": seconds, "seconds_last_ply": t_last - t_prev, "seconds_per_ply": seconds / plies,
            "peak_memory_gb": peak_gb, "launches": launches, "at_seen_ratio": at_seen,
            "ply_8_games_profile": ply8, f"card_equals_cpu_at_batch_{small}": True}


def run_graph_and_books(dev, out) -> dict:
    """14e: ``drivers/graph.py`` (HTML and CSV; ``--png`` needs matplotlib,
    which raises naming the flag where it is missing) and
    ``drivers/visualize_replay_buffer.py`` on phases 9 and 11's replays,
    stepped on ``dev``.  The two streams come from different seeds and
    drivers, so each must hold positions the other lacks and their curves
    must differ: otherwise the set differences and the second curve would
    go untested."""
    import importlib.util

    from takzero_torch.drivers import graph, visualize_replay_buffer

    files = [str(Path(out, f"{tag}_replays.txt")) for tag in ("loop", "cosched")]
    on_dev = ["--n", "4", "--device", str(dev)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        curves = graph.main(files + on_dev + ["--point-rate", "256", "--out", str(Path(out, "graph.html")),
                                              "--csv", str(Path(out, "graph.csv"))])
        books = visualize_replay_buffer.main(files + on_dev + ["--out-prefix", str(Path(out, "positions"))])
    if not all(0.0 <= y <= 1.0 for pts in curves.values() for _, y in pts) or len(curves) != 2:
        raise AssertionError(f"graph: curves {curves}")
    if curves["loop"] == curves["cosched"]:
        raise AssertionError(f"graph: phases 9 and 11's replays give one curve {curves['loop']}")
    if len(books) != 3 or not all(Path(p).exists() for p in books):
        raise AssertionError(f"visualize_replay_buffer: books {books}")
    if not all(count > 0 for p, count in books.items() if Path(p).name.startswith("positions_only_")):
        raise AssertionError(f"visualize_replay_buffer: a stream holds no position the other lacks: {books}")
    png = "written"
    if importlib.util.find_spec("matplotlib") is None:
        try:
            graph.main(files[:1] + on_dev + ["--out", str(Path(out, "g.html")), "--png", str(Path(out, "g.png"))])
        except ImportError as exc:
            if "--png" not in str(exc):
                raise
            png = f"refused without matplotlib: {exc}"
        else:
            raise AssertionError("graph --png ran without matplotlib")
    return {"points": {k: len(v) for k, v in curves.items()}, "last_points": {k: v[-1] for k, v in curves.items()},
            "books": books, "png": png, "seconds": time.perf_counter() - t0}


def run_visualize_search(dev, out, visits: int = 200) -> dict:
    """14f: ``drivers/visualize_search.py``.  First a small RND net's tree
    (16x2, 8x1 RND towers, float32) on the card against the CPU: trees
    equal, floats within 1e-4 (phase 3c).  Then net4_rnd at full width,
    ``visits`` visits, betas 0 and 1: each SVG written, the root visits
    equal the visits, kernel A once per simulation at f32[1, 944] with
    k=64 and B never; A's recorded inputs equal ``topk_plain``'s at k = 1,
    64 and 944, and A timed at k=64 beside ``torch.topk``."""
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import visualize_search
    from takzero_torch.eee.harness import random_draws
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.ops import topk
    from takzero_torch.search.core import make_simulate
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.tak.engine import engine

    eng = engine(4, half_komi=4)
    small = NetConfig(n=4, half_komi=4, filters=16, blocks=2, novelty="rnd", rnd_filters=8, rnd_blocks=1,
                      compute_dtype=torch.float32)
    draws = random_draws(torch.Generator().manual_seed(3), 1, eng.num_actions)
    gumbel = torch.stack([draws["gumbel"](i) for i in range(3)])
    trees = {}
    for where in ("cpu", dev):
        agent = new_agent(small, seed=0, device=where)
        evaluate = make_net_evaluate(small, eng, device=where)
        simulate = make_simulate(eng, lambda e: evaluate(agent, e), max_depth=64)
        envs = make_new_opening(eng, random_steps=3)(draws["sym"].to(where), draws["pair"].to(where), gumbel.to(where))
        trees[str(where)] = visualize_search.search_tree(eng, simulate, envs, 1.0, 48, 64)
    expect_trees_close(trees[str(dev)], trees["cpu"], "visualize_search, small net", 1e-4)

    calls = []
    zero_launches()
    t0 = time.perf_counter()
    with recording_kernel_inputs(calls), contextlib.redirect_stdout(io.StringIO()):
        drawn = visualize_search.main(["--net", "net4_rnd", "--visits", str(visits), "--betas", "0,1",
                                       "--out-dir", str(out), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _expect_launches("visualize_search", per_simulation(NET_PRESETS["net4_rnd"]), 2 * visits)
    for path, host in drawn:
        if not path.stat().st_size or int(host["root_visit"]) != visits:
            raise AssertionError(f"visualize_search: {path} ({path.stat().st_size} bytes), root visits "
                                 f"{int(host['root_visit'])}, expected {visits}")
    a_in = [(x, k) for w, x, k, _ in calls if w == "A"]
    if {(tuple(x.shape), k) for x, k in a_in} != {((1, 944), 64)} or len(a_in) != 2 * visits:
        raise AssertionError(f"visualize_search: kernel A inputs {sorted({(tuple(x.shape), k) for x, k in a_in})}")
    for i in (0, visits, 2 * visits - 1):
        for k in (1, 64, 944):
            expect_topk_equal(a_in[i][0], k, f"visualize_search simulation {i}, k={k}")
    x, k = a_in[-1]
    b, a = x.shape
    at = dict(shape=[b, a], k=k, max_abs_err=0.0, kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(x, k))[0],
              call_ms=call_ms(lambda: topk.exact_top_k_unsorted(x, k)),
              plain_ms=device_ms(lambda: topk.topk_plain(x, k))[0],
              library_ms=device_ms(lambda: torch.topk(x, k, sorted=False))[0],
              legal_entries=int((x > NEG / 2).sum()))
    at["bound_ms"], at["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    return {"net": "net4_rnd (16x256 bf16, two 32x4 RND towers)", "visits": visits, "betas": [0.0, 1.0],
            "small_net_card_vs_cpu": "trees equal (floats 1e-4)", "seconds": seconds,
            "simulations_per_s": 2 * visits / seconds, "launches": launches,
            "svg_bytes": [p.stat().st_size for p, _ in drawn], "at_1x944": at}


def run_eee_and_visualizers(dev, keep) -> dict:
    """14: the EEE experiments and the visualizers on phases 9 and 11's
    files (kept in ``keep``)."""
    import torch

    from takzero_torch.parallel import coordinator as co

    t_phase = time.perf_counter()
    keep = Path(keep)
    replays, targets = keep / "eee_replays.txt", keep / "eee_targets.txt"
    replays.write_text("".join((keep / f"{t}_{co.REPLAYS}").read_text(encoding="utf-8") for t in ("loop", "cosched")),
                       encoding="utf-8")
    # Selfplay targets first, reanalyze targets second: the experiment's two
    # forced-uses pools are the file's halves (ensemble.rs:43-54).
    targets.write_text("".join((keep / f"{t}_{name}").read_text(encoding="utf-8")
                               for name in (co.TARGETS_SELFPLAY, co.TARGETS_REANALYZE) for t in ("loop", "cosched")),
                       encoding="utf-8")
    res = {"phase": "EEE and the visualizers", "card": card_line()}
    t0 = time.perf_counter()
    res["generalization"] = run_eee_generalization(dev, replays, keep)
    res["rnd"] = run_eee_rnd(dev, replays, keep)
    res["ensemble_small_card_vs_cpu"] = check_ensemble_step_card_vs_cpu(dev, targets)
    res["ensemble"] = run_eee_ensemble(dev, targets, keep)
    res["eee_seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    res["seen_ratio"] = run_seen_ratio(dev, keep)
    res["graph_and_books"] = run_graph_and_books(dev, keep)
    res["visualize_search"] = run_visualize_search(dev, keep)
    res["seconds"] = time.perf_counter() - t_phase
    log(res)
    return res


# ---------------------------------------------------------------------------
# Phase 15: the rules oracle and the offline tools.
# ---------------------------------------------------------------------------

PROVER_BUDGET, PROVER_BATCH, PROVER_CHILDREN, VERIFY_NODES = 256, 64, 128, 20_000
REUSE_AB_BUDGET = 24


def time_topk(x, k: int) -> dict:
    """Kernel A at x's shape: device and call time, the plain version's,
    ``torch.topk``'s and the bound."""
    import torch

    from takzero_torch.ops import topk

    b, a = x.shape
    out = dict(shape=[b, a], k=k, kernel_ms=device_ms(lambda: topk.exact_top_k_unsorted(x, k))[0],
               call_ms=call_ms(lambda: topk.exact_top_k_unsorted(x, k)),
               plain_ms=device_ms(lambda: topk.topk_plain(x, k))[0],
               library_ms=device_ms(lambda: torch.topk(x, k, sorted=False))[0])
    out["bound_ms"], out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    return out


def build_oracle_and_fuzz(dev, games: int = 2) -> dict:
    """15a: build the C++ oracle library and the MCTS bench, then fuzz the
    port's engine on the card against the oracle at 6x6: at every ply of
    ``games`` random games the legal mask, the stepped state (every field)
    and the result must equal the oracle's."""
    import numpy as np
    import torch

    from takzero_torch.ops import _cpp_build
    from takzero_torch.tak.engine import engine
    from takzero_torch.tak.oracle import Oracle
    from takzero_torch.tak.state import TakState

    seconds = {}
    for name in _cpp_build.TARGETS:
        t0 = time.perf_counter()
        _cpp_build.build(name)
        seconds[name] = time.perf_counter() - t0
    eng, orc = engine(6, half_komi=4), Oracle(6, 4)
    rng = np.random.default_rng(1240)
    plies = 0
    t0 = time.perf_counter()
    for g in range(games):
        state = eng.initial(1, dev)
        ply = 0
        while True:
            lane = state.map(lambda x: x[0].cpu())
            mask = eng.legal_mask(state)[0].cpu().numpy()
            if not np.array_equal(mask, orc.legal_mask(lane)):
                raise AssertionError(f"engine on the card vs oracle, game {g} ply {ply}: legal masks differ")
            res = int(eng.game_result(state)[0])
            if res != orc.result(lane):
                raise AssertionError(f"engine on the card vs oracle, game {g} ply {ply}: result {res}")
            if res != -1 or ply > 250:
                break
            action = int(rng.choice(np.nonzero(mask)[0]))
            state = eng.step(state, torch.tensor([action], device=dev))
            want = orc.step(lane, action)
            for name, got, exp in zip(TakState._fields, state.map(lambda x: x[0].cpu()), want):
                if not torch.equal(got.to(exp.dtype), exp):
                    raise AssertionError(f"engine on the card vs oracle, game {g} ply {ply}: {name} differs")
            ply += 1
        plies += ply
    out = {"phase": "oracle: build and engine fuzz on the card", "build_seconds": seconds, "games": games,
           "plies": plies, "fuzz_seconds": time.perf_counter() - t0}
    log(out)
    return out


def run_make_puzzles(dev, out_dir) -> dict:
    """15b: ``tools.make_puzzles`` at 6x6, full width, depth cut: 8 games,
    batch 64, budget 256, C=128, no deep pass, 20,000 verifier nodes,
    target 2, 20 s.  Kernel A must launch budget + 1 times a solve (the
    counters) and B never; the inputs of the last solve must equal
    ``topk_plain``'s at k = 1, 128 and A; A timed at that shape beside
    ``torch.topk``; every written row re-checks on the oracle."""
    import sqlite3

    import torch

    from takzero_torch.tak.moves import ptn_to_action
    from takzero_torch.tak.oracle import Oracle
    from takzero_torch.tak.tps import tps_to_state
    from takzero_torch.tools import make_puzzles as mp

    db = Path(out_dir) / "puzzles_smoke.db"
    solve_s = []
    real = mp.make_solver

    def timed_solver(*args, **kwargs):
        solve = real(*args, **kwargs)

        def timed(states):
            t0 = time.perf_counter()
            tree = solve(states)
            torch.cuda.synchronize()
            solve_s.append(time.perf_counter() - t0)
            return tree

        return timed

    calls = []
    zero_launches()
    mp.make_solver = timed_solver
    try:
        with recording_kernel_inputs(calls, last=PROVER_BUDGET + 1):
            res = mp.main(["--out", str(db), "--size", "6", "--games", "8", "--budget", str(PROVER_BUDGET),
                           "--batch", str(PROVER_BATCH), "--max-children", str(PROVER_CHILDREN),
                           "--deep-budget", "0", "--verify-nodes", str(VERIFY_NODES), "--target", "2",
                           "--time-limit", "20", "--seed", "0", "--device", str(dev)])
    finally:
        mp.make_solver = real
    torch.cuda.synchronize()
    if res["solves"] < 1 or len(solve_s) != res["solves"]:
        raise AssertionError(f"make_puzzles: {res['solves']} solves, {len(solve_s)} timed")
    launches = _expect_launches("make_puzzles prover", {"exact_top_k_unsorted": 1, "simhash_pack": 0},
                                (PROVER_BUDGET + 1) * res["solves"])
    if len(calls) != PROVER_BUDGET + 1 or {(c[0], tuple(c[1].shape), c[2]) for c in calls} != {
            ("A", (PROVER_BATCH, 9036), PROVER_CHILDREN)}:
        raise AssertionError(f"make_puzzles: recorded {len(calls)} kernel calls of the last solve, "
                             f"{sorted({(c[0], tuple(c[1].shape), c[2]) for c in calls})}")
    for i, (_, x, _, _) in enumerate(calls):
        for k in (1, PROVER_CHILDREN, x.shape[1]):
            expect_topk_equal(x, k, f"prover call {i}, k={k}")
    at_prover = time_topk(calls[len(calls) // 2][1], PROVER_CHILDREN)
    del calls
    orc = Oracle(6, 4)
    rows = sqlite3.connect(db).execute(
        "SELECT tps, solution, tinue_length, tinue_avoidance_length FROM puzzles").fetchall()
    for tps, sol, tl, al in rows:
        st = tps_to_state(6, tps)
        if not orc.legal_mask(st)[ptn_to_action(6, sol)]:
            raise AssertionError(f"make_puzzles: solution {sol} illegal in {tps}")
        if tl is not None and orc.tinue_depth(st, 9, VERIFY_NODES) != tl:
            raise AssertionError(f"make_puzzles: tinue {tps} is not depth {tl} on the oracle")
        if al is not None and (mp.verify_avoidance(orc, st, {2, 4, 6}, VERIFY_NODES) or (None,))[0] != al:
            raise AssertionError(f"make_puzzles: avoidance {tps} is not depth {al} on the oracle")
    out = {"phase": "oracle: make_puzzles (device prover)", "card": card_line(),
           "cuts": {"games": 8, "budget": PROVER_BUDGET, "batch": PROVER_BATCH, "max_children": PROVER_CHILDREN,
                    "deep_budget": 0, "verify_nodes": VERIFY_NODES, "target": 2, "time_limit": 20},
           "candidates": res["candidates"], "solves": res["solves"], "seconds_per_solve": solve_s,
           "seconds": res["seconds"], "rows": len(rows), "written": res["summary"], "discards": res["discards"],
           "launches": launches, "launches_per_solve": {k: v / res["solves"] for k, v in launches.items()},
           "at_prover": at_prover}
    log(out)
    return out


def run_elo_curve(dev, out_dir) -> dict:
    """15c: ``tools.elo_curve`` over two numbered net4_simhash checkpoints
    (``new_agent`` seeds 1 and 2), one round of 4 games, budget 8, k=4:
    the evaluation subprocess runs on the card (``--device``; it raises
    without CUDA), the CSV and the curve are written with finite points,
    and ``--skip-matches`` re-fits to the same rows."""
    import math

    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.models.agent import new_agent
    from takzero_torch.tools import elo_curve
    from takzero_torch.utils import ckpt

    d = Path(out_dir) / "elo_curve_run"
    for seed, name in ((1, "model_0000000.ckpt"), (2, "model_0000100.ckpt")):
        ckpt.save_checkpoint(d, name, new_agent(NET_PRESETS["net4_simhash"], seed=seed, device=dev))
    torch.cuda.empty_cache()
    args = ["--directory", str(d), "--net", "net4_simhash", "--device", str(dev)]
    t0 = time.perf_counter()
    rows = elo_curve.main(args + ["--rounds", "1", "--games", "4", "--budget", "8", "--sampled", "4",
                                  "--rss-limit-gb", "0"])
    seconds = time.perf_counter() - t0
    data = json.loads((d / "elo_curve.json").read_text())
    csv = (d / "match_results.csv").read_text().splitlines()
    if len(csv) != 2 or data["curve"] != rows or [r["steps"] for r in rows] != [0, 100]:
        raise AssertionError(f"elo_curve: {len(csv)} CSV rows, curve {data['curve']}")
    if not all(math.isfinite(r["elo"]) and math.isfinite(r["stderr"]) and r["stderr"] > 0 for r in rows):
        raise AssertionError(f"elo_curve: points not finite {rows}")
    if elo_curve.main(args + ["--skip-matches"]) != rows:
        raise AssertionError("elo_curve: --skip-matches re-fit to other rows")
    out = {"phase": "oracle: elo_curve", "card": card_line(), "net": "net4_simhash (16x256 bf16, SimHash 2^32)",
           "cuts": {"rounds": 1, "games": 4, "budget": 8, "sampled": 4}, "csv": csv, "curve": rows,
           "seconds": seconds}
    log(out)
    return out


def run_reuse_ab(dev, out_dir) -> dict:
    """15d: ``tools.reuse_ab`` at net6_simhash on a ``new_agent``
    checkpoint, 64 games a direction, budget 24, k=8, 4 moves a side: A and
    B each launch budget + 1 times a half-move (the counters); the last
    half-move's kernel inputs equal the plain versions' (B under phase 4's
    rule); B timed at [64, 1296] x [1296, 32]."""
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.models.agent import new_agent
    from takzero_torch.tools import reuse_ab
    from takzero_torch.utils import ckpt

    model = ckpt.save_checkpoint(out_dir, "reuse_ab.ckpt", new_agent(NET_PRESETS["net6_simhash"], seed=5,
                                                                     device=dev))
    torch.cuda.empty_cache()
    calls = []
    zero_launches()
    with recording_kernel_inputs(calls, last=2 * (REUSE_AB_BUDGET + 1)):
        summary = reuse_ab.main(["--ckpt", str(model), "--net", "net6_simhash", "--budget", str(REUSE_AB_BUDGET),
                                 "--sampled", "8", "--max-moves", "4", "--device", str(dev)])
    torch.cuda.synchronize()
    half = summary["half_moves"]
    launches = _expect_launches("reuse_ab", per_simulation(NET_PRESETS["net6_simhash"]), (REUSE_AB_BUDGET + 1) * half)
    # 4 moves a side: no 6x6 game can end, so every direction runs 8
    # half-moves and no game is scored.
    if half != 16 or not 0 <= summary["games"] <= 128:
        raise AssertionError(f"reuse_ab: {half} half-moves, {summary['games']} games scored")
    shapes = sorted({(c[0], tuple(c[1].shape)) for c in calls})
    if shapes != [("A", (64, 9036)), ("B", (64, 1296))] or len(calls) != 2 * (REUSE_AB_BUDGET + 1):
        raise AssertionError(f"reuse_ab: recorded {len(calls)} calls of shapes {shapes}")
    err = 0.0
    for i, (kernel, x, arg, _) in enumerate(calls):
        if kernel == "A":
            expect_topk_equal(x, arg, f"reuse_ab call {i}")
        else:
            err = max(err, expect_simhash_equal(x, arg, f"reuse_ab call {i}"))
    b_call = next(c for c in calls if c[0] == "B")
    at_reuse_ab = {**time_simhash(b_call[1], b_call[2]), "max_abs_err": err}
    del calls
    out = {"phase": "oracle: reuse_ab", "card": card_line(), "net": "net6_simhash (16x256 bf16, SimHash 2^32)",
           "summary": summary, "seconds_per_half_move": summary["wall_s"] / half, "launches": launches,
           "launches_per_half_move": {k: v / half for k, v in launches.items()}, "at_reuse_ab": at_reuse_ab}
    log(out)
    return out


def run_anchor_and_openings(dev, out_dir) -> dict:
    """15e: ``tools.anchor --quick`` (the C++ bench's sims/s on one host
    core, the 16x256 float32 network's positions/s on the card); 15f:
    ``tools.openings`` at 4x4, depth 3: the count, and every book parses
    back to its TPS."""
    import torch

    from takzero_torch.tak.tps import state_to_tps, tps_to_state
    from takzero_torch.tools import anchor, openings

    with contextlib.redirect_stdout(io.StringIO()):
        res = anchor.main(["--quick", "--device", str(dev)])
    key = f"host_nn_positions_per_s_torch_{torch.device(dev).type}"
    if not (res["host_search_sims_per_s_1core_no_nn"] > 0 and res[key] > 0):
        raise AssertionError(f"anchor: {res}")
    books = Path(out_dir) / "openings_4x4_d3.txt"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        openings.main(["--size", "4", "--depth", "3", "--out", str(books)])
    seconds = time.perf_counter() - t0
    lines = books.read_text().splitlines()
    for line in lines:
        if state_to_tps(4, tps_to_state(4, line)) != line:
            raise AssertionError(f"openings: {line!r} does not parse back")
    out = {"phase": "oracle: anchor and openings", "card": card_line(),
           "anchor": {"search_sims_per_s_1core": res["host_search_sims_per_s_1core_no_nn"],
                      "nn_positions_per_s_card": res[key], "composed_per_actor": res[
                          "reference_on_this_host_sims_per_s_per_actor"], "host_cores": res["host_cores"]},
           "openings_4x4_depth3": len(lines), "openings_seconds": seconds}
    log(out)
    return out


def run_oracle_and_tools(dev) -> dict:
    """15: the rules oracle and the offline tools (15a-15f)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="takzero_tools_") as d:
        res = {"fuzz": build_oracle_and_fuzz(dev), "puzzles": run_make_puzzles(dev, d),
               "elo_curve": run_elo_curve(dev, d), "reuse_ab": run_reuse_ab(dev, d),
               "anchor_openings": run_anchor_and_openings(dev, d)}
    res["seconds"] = time.perf_counter() - t0
    log({"phase": "oracle and tools done", "seconds": res["seconds"]})
    return res


# ---------------------------------------------------------------------------
# Phase 16: multi-device on the card.
# ---------------------------------------------------------------------------

SP16 = {"batch": 128, "sampled": 8, "budget": 24, "games": 16}  # 16c, net4_simhash, in bf16 and float32


class _Lines(list):
    """A logging handler's stand-in: keeps the messages of one logger."""

    def __init__(self, name: str):
        import logging

        super().__init__()
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.append(record.getMessage())
        self.logger.addHandler(self.handler)

    def close(self):
        self.logger.removeHandler(self.handler)


def _params_digest(bundle) -> str:
    """A checksum of the bits of every weight and statistic of the net."""
    import hashlib

    digest = hashlib.sha256()
    for name, t in bundle["net"].state_dict().items():
        digest.update(name.encode())
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def _rank_learn(driver_main, argv) -> dict:
    """16b, in each rank (or in this process at world 1): ``drivers.learn``
    with the kernel inputs recorded; returns the result, this rank's
    launch counters, a digest of its final weights, its seen-set, the
    first step's loss and the time of each gradient all-reduce."""
    import torch

    from takzero_torch.drivers import learn
    from takzero_torch.parallel import multihost

    held, reduce_ms, calls = {}, [], []
    new_agent, flat = learn.new_agent, multihost.all_reduce_flat

    def keep(*a, **k):
        held["bundle"] = new_agent(*a, **k)
        return held["bundle"]

    def timed(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat(tensors)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    float32_without_tf32()
    lines = _Lines("learn")
    learn.new_agent, multihost.all_reduce_flat = keep, timed
    zero_launches()
    try:
        with recording_kernel_inputs(calls, last=2):
            result = driver_main(argv)
        torch.cuda.synchronize()
    finally:
        learn.new_agent, multihost.all_reduce_flat = new_agent, flat
        lines.close()
    first = next(x for x in lines if x.startswith("pretrain 0:"))
    bundle = held["bundle"]
    return {"result": result, "launches": _launches(*AB), "digest": _params_digest(bundle),
            "hash_bits": bundle["hash_bits"].cpu(), "hash_matrix": bundle["hash_matrix"].cpu(),
            "first_loss": float(re.search(r"'loss': ([-+\d.eE]+)", first).group(1)), "reduce_ms": reduce_ms,
            "calls": [(k, x.cpu(), None) for k, x, _, _ in calls], "rank": multihost.rank()}


def _rank_selfplay(driver_main, argv, float32: bool = True) -> dict:
    """16c, in each rank: ``drivers.selfplay`` (in float32 unless
    ``float32`` is False) with the last move's kernel inputs recorded and
    each move's gather timed; returns the result, this rank's counters and
    the gathers' milliseconds."""
    import torch

    from takzero_torch.parallel import multihost

    calls, gather_ms = [], []
    gather = multihost.all_gather_rows

    def timed(x, dim=0):
        torch.cuda.synchronize()  # this rank's move is done: time the collective alone
        t0 = time.perf_counter()
        out = gather(x, dim)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    float32_without_tf32()
    zero_launches()
    multihost.all_gather_rows = timed
    try:
        with recording_kernel_inputs(calls, last=2 * (SP16["budget"] + 1)), \
                float32_presets(*(F32_NETS if float32 else ())):
            result = driver_main(argv)
        torch.cuda.synchronize()
    finally:
        multihost.all_gather_rows = gather
    result.pop("agent")
    return {"result": result, "launches": _launches(*AB, "conv3x3"), "rank": multihost.rank(),
            "gather_ms": gather_ms,
            "calls": [(k, x.cpu(), arg if k == "A" else arg.cpu()) for k, x, arg, _ in calls]}


def _collectives(dev) -> dict:
    """16a: each collective the port uses, with rank-dependent inputs on ``dev``."""
    import torch

    from takzero_torch.parallel import multihost

    r = multihost.rank()
    grads = [torch.full((3, 5), float(r + 1), device=dev), torch.arange(4.0, device=dev) * (r + 1)]
    multihost.all_reduce_flat(grads)
    return {
        "backend": multihost.dist.get_backend(), "rank": r, "size": multihost.world_size(),
        "scalar": multihost.broadcast_scalar(7 + r),
        "lines": multihost.broadcast_lines([f"rank {r} line {i}" for i in range(3)] if r == 0 else None),
        "gather": multihost.all_gather_rows(torch.arange(3, device=dev) + 10 * r).tolist(),
        "gather_bool": multihost.all_gather_rows(torch.tensor([r == 0], device=dev)).tolist(),
        "flat": [g.cpu().tolist() for g in grads],
        "sum_grad": _differentiable_sum(dev, r),
    }


def _differentiable_sum(dev, r: int) -> list:
    import torch

    from takzero_torch.parallel import multihost

    x = torch.full((2,), float(r + 1), device=dev, requires_grad=True)
    (multihost.all_reduce_sum(x) * (r + 1)).sum().backward()
    return x.grad.cpu().tolist()


def _expect_collectives(outs: list, what: str) -> None:
    n = len(outs)
    for o in outs:
        want = {"scalar": 7, "lines": [f"rank 0 line {i}" for i in range(3)],
                "gather": [v + 10 * r for r in range(n) for v in range(3)],
                "gather_bool": [r == 0 for r in range(n)],
                "flat": [[[float(n * (n + 1) / 2)] * 5] * 3, [float(i * n * (n + 1) / 2) for i in range(4)]],
                "sum_grad": [float(n * (n + 1) / 2)] * 2}
        got = {k: o[k] for k in want}
        if got != want:
            raise AssertionError(f"{what}: rank {o['rank']} got {got}, expected {want}")


@contextlib.contextmanager
def float32_presets(*nets: str):
    """Inside, each preset of ``nets`` computes in float32 (the same widths)."""
    import dataclasses

    import torch

    from takzero_torch.config import NET_PRESETS

    saved = {net: NET_PRESETS[net] for net in nets}
    for net, cfg in saved.items():
        NET_PRESETS[net] = dataclasses.replace(cfg, compute_dtype=torch.float32)
    try:
        yield
    finally:
        NET_PRESETS.update(saved)


F32_NETS = ("net4_simhash", "net6_simhash")  # 16c and 16d's float32 runs


def _rank_drivers(argv) -> dict:
    """16a and 16d, in each of two gloo ranks on card 0: the collectives,
    then reanalyze in bf16 and float32, and evaluation, puzzle and the
    co-scheduled driver in float32, each with this rank's counters."""
    import torch

    from takzero_torch.drivers import coscheduled, evaluation, puzzle, reanalyze

    dev = torch.device(argv["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        float32_without_tf32()
    out = {"collectives": _collectives(dev)}
    for name, main in (("reanalyze", reanalyze.main), ("reanalyze_f32", reanalyze.main),
                       ("evaluation", evaluation.main), ("puzzle", puzzle.main), ("coscheduled", coscheduled.main)):
        zero_launches()
        t0 = time.perf_counter()
        with float32_presets(*(() if name == "reanalyze" else F32_NETS)):
            res = main(argv[name])
        torch.cuda.synchronize()
        if isinstance(res, dict):
            res.pop("agent", None)
        out[name] = {"result": res, "launches": _launches(*AB, "conv3x3"),
                     "seconds": time.perf_counter() - t0}
    return out


def padded_evaluator_gap(net: str, dev) -> dict:
    """The largest |difference| of the bf16 evaluator's outputs (logits,
    value, variance) on 128 random positions evaluated at once and as two
    ranks' halves of 64: ``padded`` through each rank's evaluator
    (``make_net_evaluate(world=...)``, which runs the halves at the global
    shape), which must be 0, and ``unpadded`` (each half alone), the gap
    that parted two ranks' bf16 games from one rank's before the padding."""
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.parallel.mesh import World
    from takzero_torch.tak.engine import engine

    cfg = NET_PRESETS[net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    envs = random_positions(eng, 128, 3 * cfg.n * cfg.n // 2, torch.Generator(device=dev).manual_seed(16), dev)
    agent = new_agent(cfg, seed=16, device=dev)
    whole = make_net_evaluate(cfg, eng, device=dev)(agent, envs)
    halves = [envs.map(lambda x: x[s]) for s in (slice(0, 64), slice(64, 128))]
    gaps = {}
    for name, evaluates in (
        ("padded", [make_net_evaluate(cfg, eng, device=dev, world=World(rank=r, size=2, device=dev))
                    for r in (0, 1)]),
        ("unpadded", [make_net_evaluate(cfg, eng, device=dev)] * 2),
    ):
        parts = [evaluate(agent, h) for evaluate, h in zip(evaluates, halves)]
        gaps[name] = max(float((torch.cat([a, b]) - w).abs().max()) for w, a, b in zip(whole, *parts))
    if gaps["padded"] != 0.0:
        raise AssertionError(f"{net}: the padded bf16 evaluator's halves differ from the whole batch by "
                             f"{gaps['padded']}")
    return gaps


def _expect_equal_lines(what: str, a: list, b: list) -> None:
    if a != b:
        raise AssertionError(f"{what}: world 2 differs from world 1 at {_first_replay_difference(a, b)}")


def _first_replay_difference(a: list, b: list):
    for g, (x, y) in enumerate(zip(a, b)):
        if x != y:
            mx, my = x.split(), y.split()
            move = next((i for i, (p, q) in enumerate(zip(mx, my)) if p != q), min(len(mx), len(my)))
            return {"line": g, "token": move, "world1": " ".join(mx[max(0, move - 2):move + 2])[:160],
                    "world2": " ".join(my[max(0, move - 2):move + 2])[:160]}
    return {"line": min(len(a), len(b)), "lengths": [len(a), len(b)]}


def _launcher(driver: str, argv: list, hook) -> list:
    """``drivers.multihost`` with two local gloo ranks on card 0; every
    rank's hook result, in rank order."""
    from takzero_torch.drivers import multihost as launcher

    with tempfile.TemporaryDirectory(prefix="takzero_rdzv_") as r:
        outs = launcher.main(["--coordinator", f"file://{r}/rendezvous", "--num-processes", "1", "--process-id", "0",
                              "--local-ranks", "2", "--backend", "gloo", driver, "--", *argv], rank_hook=hook)
    if [o["rank"] for o in outs] != [0, 1]:
        raise AssertionError(f"launcher {driver}: ranks {[o['rank'] for o in outs]}")
    return outs


def run_multi_device(dev) -> dict:
    """Phase 16 (a-e)."""
    import json

    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers import coscheduled, evaluation, learn, puzzle, reanalyze, selfplay
    from takzero_torch.models.agent import new_agent
    from takzero_torch.ops.bitset import bitset_init, bitset_set
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.parallel import multihost
    from takzero_torch.tak.engine import engine
    from takzero_torch.tools import multihost_scaling
    from takzero_torch.train.data import random_pretraining_targets
    from takzero_torch.utils import ckpt

    from takzero_torch.parallel.mesh import backend_for

    t_phase = time.perf_counter()
    shared = f"{dev.type}:0" if dev.type == "cuda" else "cpu"  # the --device of ranks that share the card
    out = {"phase": "multi-device", "card": card_line(),
           "note": "two ranks share one card under gloo: the collectives' cost, not scaling"}

    # (a) NCCL at world 1 in this process.
    with tempfile.TemporaryDirectory(prefix="takzero_rdzv_") as r:
        multihost.initialize(f"file://{r}/rendezvous", 1, 0, backend_for(dev))
        try:
            nccl = _collectives(dev)
        finally:
            multihost.dist.destroy_process_group()
    _expect_collectives([nccl], "NCCL world 1")
    out["nccl_world1"] = nccl["backend"]

    with tempfile.TemporaryDirectory(prefix="takzero_multi_") as d:
        d = Path(d)
        # (b) the learner: net6_simhash, global batch 128, phase 8's
        # pre-training cut, then 10 steps in chunks of 2.
        cfg6 = NET_PRESETS["net6_simhash"]
        eng6 = engine(cfg6.n, half_komi=cfg6.half_komi)
        targets = "".join(t.to_line() + "\n" for t in random_pretraining_targets(
            eng6, 1280, np.random.default_rng(1), device=dev))
        argv = ["--net", "net6_simhash", "--batch-size", "128", "--no-wait", "--seed", "0", "--pretrain-targets",
                "1280", "--pretrain-steps", "10", "--max-steps", "10", "--chunk-steps", "2",
                "--steps-per-checkpoint", "20"]
        runs = {}
        for name in ("w1", "w2"):
            (d / name).mkdir()
            (d / name / co.TARGETS_SELFPLAY).write_text(targets)
        t0 = time.perf_counter()
        runs["w1"] = [_rank_learn(learn.main, ["--directory", str(d / "w1"), *argv, "--device", dev.type,
                                              "--devices", "1"])]
        w1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs["w2"] = _launcher("learn", ["--directory", str(d / "w2"), *argv, "--device", shared], _rank_learn)
        w2_s = time.perf_counter() - t0
        expect = _expected_learner_launches(10, [(10, 10, 2, 20)])
        for name, ranks in runs.items():
            for o in ranks:
                if o["launches"] != {"exact_top_k_unsorted": 0, "simhash_pack": expect}:
                    raise AssertionError(f"learner {name} rank {o['rank']}: launches {o['launches']}, "
                                         f"expected kernel B {expect} and kernel A 0")
            if len({o["digest"] for o in ranks}) != 1:
                raise AssertionError(f"learner {name}: ranks end with different weights")
            idx, _ = ckpt.read_hash_indices(d / name / ckpt.HASH_LOG, 0)
            rebuilt = bitset_set(bitset_init(cfg6.hash_bits), torch.from_numpy(idx.astype(np.int64)))
            if not all(torch.equal(rebuilt, o["hash_bits"]) for o in ranks):
                raise AssertionError(f"learner {name}: the seen-set differs from the one rebuilt from hash_log.bin")
            rows = [json.loads(x)["step"] for x in (d / name / "metrics.jsonl").read_text().splitlines()]
            if rows != list(range(11, 21)):
                raise AssertionError(f"learner {name}: metrics.jsonl steps {rows}")
        l1, l2 = runs["w1"][0]["first_loss"], runs["w2"][0]["first_loss"]
        if abs(l1 - l2) > 1e-3 * abs(l1):
            raise AssertionError(f"learner: first step's loss {l2} on two ranks, {l1} on one")
        rank_rows = [x for o in runs["w2"] for k, x, _ in o["calls"] if k == "B"]
        m6 = runs["w2"][0]["hash_matrix"].to(dev)
        err_b = max(expect_simhash_equal(x.to(dev), m6, "learner rank rows") for x in rank_rows)
        at_learner = {**time_simhash(next(x for x in rank_rows if x.shape[0] == 64).to(dev), m6), "max_abs_err": err_b}
        reduce2 = [ms for o in runs["w2"] for ms in o["reduce_ms"][3:]]  # after warm-up
        reduce1 = runs["w1"][0]["reduce_ms"][3:]
        steps1, steps2 = (runs[n][0]["result"] for n in ("w1", "w2"))
        out["learner"] = {
            "net": "net6_simhash (16x256 bf16, SimHash 2^32)", "global_batch": 128,
            "world1_nccl_steps_per_s": steps1["steps"] / steps1["seconds"],
            "world2_gloo_one_card_steps_per_s": steps2["steps"] / steps2["seconds"],
            "allreduce_ms_world1_nccl": float(np.mean(reduce1)), "allreduce_ms_world2_gloo": float(np.mean(reduce2)),
            "first_loss": [l1, l2], "launches_per_rank": [o["launches"] for o in runs["w2"]],
            "kernel_b_rank_rows": sorted({tuple(x.shape) for x in rank_rows}), "at_rank_learner": at_learner,
            "seconds": [w1_s, w2_s],
        }
        log({"phase": "multi-device: learner", **out["learner"]})

        # (c) selfplay: net4_simhash, 128 games (64 a rank), until 16
        # finish, in bf16 (the preset) and at its widths in float32.  The
        # ranks evaluate at the global batch's shape, so two ranks must
        # write world 1's bytes in both.
        gaps = padded_evaluator_gap("net4_simhash", dev)
        sp = ["--net", "net4_simhash", "--seed", "3", "--batch", str(SP16["batch"]), "--budget",
              str(SP16["budget"]), "--sampled", str(SP16["sampled"]), "--max-games", str(SP16["games"])]
        runs, seconds, files = {}, {}, {}
        for dtype, float32 in (("bfloat16", False), ("float32", True)):
            for name in ("s1", "s2"):
                (d / f"{name}_{dtype}").mkdir()
            t0 = time.perf_counter()
            with float32_presets(*(F32_NETS if float32 else ())):
                one = selfplay.main(["--directory", str(d / f"s1_{dtype}"), *sp, "--device", str(dev)])
                conv_per = per_evaluation(NET_PRESETS["net4_simhash"])["conv3x3"]  # 0 in float32
            t1 = time.perf_counter()
            two = _launcher("selfplay", ["--directory", str(d / f"s2_{dtype}"), *sp, "--device", shared],
                            functools.partial(_rank_selfplay, float32=float32))
            runs[dtype], seconds[dtype] = (one, two), [t1 - t0, time.perf_counter() - t1]
            moves = two[0]["result"]["moves"]
            for o in two:
                per = {k: v / moves for k, v in o["launches"].items()}
                evals = SP16["budget"] + 1  # at the global batch's shape, each with its launches
                if per != {"exact_top_k_unsorted": evals, "simhash_pack": evals, "conv3x3": evals * conv_per}:
                    raise AssertionError(f"selfplay {dtype} rank {o['rank']}: {per} launches a move, "
                                         f"expected budget + 1 and {conv_per} convolutions an evaluation")
            replays = (d / f"s2_{dtype}" / co.REPLAYS).read_text().splitlines()
            if len(replays) != two[0]["result"]["replays"] or two[1]["result"]["replays"] != len(replays):
                raise AssertionError(f"selfplay {dtype}: {len(replays)} replay lines, the ranks counted "
                                     f"{[o['result']['replays'] for o in two]}")
            files[dtype] = {}
            for f in (co.REPLAYS, co.TARGETS_SELFPLAY):
                a, b = ((d / f"{n}_{dtype}" / f).read_text().splitlines() for n in ("s1", "s2"))
                _expect_equal_lines(f"selfplay {dtype} {f}", a, b)
                files[dtype][f] = len(a)
        calls = [c for dtype in runs for o in runs[dtype][1] for c in o["calls"]]
        shapes = sorted({(k, tuple(x.shape)) for k, x, _ in calls})
        if shapes != [("A", (64, 944)), ("B", (64, 448))]:
            raise AssertionError(f"selfplay ranks: kernel shapes {shapes}")
        err = 0.0
        for i, (k, x, arg) in enumerate(calls):
            if k == "A":
                expect_topk_equal(x.to(dev), arg, f"selfplay rank call {i}")
            else:
                err = max(err, expect_simhash_equal(x.to(dev), arg.to(dev), f"selfplay rank call {i}"))
        a_call = next(c for c in calls if c[0] == "A")
        b_call = next(c for c in calls if c[0] == "B")
        at_rank = {"exact_top_k_unsorted": {**time_topk(a_call[1].to(dev), a_call[2]), "max_abs_err": 0.0},
                   "simhash_pack": {**time_simhash(b_call[1].to(dev), b_call[2].to(dev)), "max_abs_err": err}}
        out["selfplay"] = {"net": "net4_simhash (16x256, SimHash 2^32), bf16 and float32", "cuts": SP16,
                           "evaluator_gap_64_vs_128": gaps, "lines_equal_to_world1": files}
        for dtype, (one, two) in runs.items():
            out["selfplay"][dtype] = {
                "moves": two[0]["result"]["moves"], "world1_moves_per_s": one["moves"] / one["seconds"],
                "world2_moves_per_s": two[0]["result"]["moves"] / two[0]["result"]["seconds"],
                # The packed buffer's gather a move (its wait for the slower rank included).
                "gather_ms_per_move": [float(np.mean(o["gather_ms"])) for o in two],
                "gather_share_of_loop": [sum(o["gather_ms"]) / 1e3 / o["result"]["seconds"] for o in two],
                "launches_per_rank": [o["launches"] for o in two], "seconds": seconds[dtype],
            }
        out["selfplay"]["launches_per_rank"] = [o["launches"] for o in runs["bfloat16"][1]]
        log({"phase": "multi-device: selfplay", **out["selfplay"]})

        # (a, d) the collectives on two gloo ranks, then the other drivers.
        cfg4 = NET_PRESETS["net4_simhash"]
        models = d / "models"
        for seed, name in ((1, "model_0000001.ckpt"), (2, "model_0000002.ckpt")):
            ckpt.save_checkpoint(models, name, new_agent(cfg4, seed=seed, device=dev))
        model6 = ckpt.save_checkpoint(d, "model6.ckpt", new_agent(cfg6, seed=6, device=dev))
        for name in ("r1", "r2", "f1", "f2"):
            shutil.copytree(d / "s1_float32", d / name)

        def drivers_argv(tag: str, device: str) -> dict:
            return {
                "device": device,
                "reanalyze": ["--directory", str(d / f"r{tag}"), "--net", "net4_simhash", "--seed", "4", "--batch",
                              "128", "--budget", "24", "--sampled", "8", "--min-positions", "128", "--max-steps", "2",
                              "--device", device],
                "reanalyze_f32": ["--directory", str(d / f"f{tag}"), "--net", "net4_simhash", "--seed", "4",
                                  "--batch", "128", "--budget", "24", "--sampled", "8", "--min-positions", "128",
                                  "--max-steps", "2", "--device", device],
                "evaluation": ["--model-path", str(models), "--net", "net4_simhash", "--rounds", "1", "--games", "32",
                               "--budget", "8", "--sampled", "4", "--max-moves", "10", "--seed", "9",
                               "--rss-limit-gb", "0", "--device", device],
                "puzzle": ["--model", str(model6), "--puzzle-db", str(PUZZLE_DB), "--net", "net6_simhash",
                           "--search-budget", "24", "--sampled-actions", "8", "--depths", "3",
                           "--avoidance-depths", "", "--device", device],
                "coscheduled": ["--directory", str(d / f"c{tag}"), "--net", "net4_simhash", "--seed", "5", "--batch",
                                "128", "--budget", "24", "--sampled", "8", "--batch-size", "128", "--max-moves", "3",
                                "--pretrain-steps", "2", "--pretrain-targets", "256", "--device", device],
            }

        t0 = time.perf_counter()
        ranks = multihost.run_ranks(_rank_drivers, drivers_argv("2", shared), 2, "gloo")
        d2_s = time.perf_counter() - t0
        _expect_collectives([o["collectives"] for o in ranks], "gloo world 2 on one card")
        t0 = time.perf_counter()
        ref = drivers_argv("1", str(dev))
        reanalyze.main(ref["reanalyze"])
        with float32_presets(*F32_NETS):
            reanalyze.main(ref["reanalyze_f32"])
            single = {"evaluation": evaluation.main(ref["evaluation"]), "puzzle": puzzle.main(ref["puzzle"])}
            cos1 = coscheduled.main(ref["coscheduled"])
        d1_s = time.perf_counter() - t0
        others = {}
        half_moves = sum(r.half_moves for *_, r in ranks[0]["evaluation"]["result"])
        per_rank = {"reanalyze": 2, "reanalyze_f32": 2, "evaluation": half_moves, "puzzle": 1,
                    "coscheduled": ranks[0]["coscheduled"]["result"]["moves"]}
        for name, count in per_rank.items():
            # Only reanalyze runs in bf16, the rest in float32 (no convolution kernel).
            conv_per = per_evaluation(cfg4)["conv3x3"] if name == "reanalyze" else 0
            for o in ranks:
                got = o[name]["launches"]["exact_top_k_unsorted"]
                budget = 9 if name == "evaluation" else 25
                if got != budget * count:
                    raise AssertionError(f"{name} rank: kernel A {got} launches, expected {budget} x {count}")
                if o[name]["launches"]["conv3x3"] != budget * count * conv_per:
                    raise AssertionError(f"{name} rank: {o[name]['launches']['conv3x3']} convolution launches, "
                                         f"expected {budget} x {count} x {conv_per}")
        for name, dtype in (("r", "bf16"), ("f", "float32")):
            a, b = ((d / f"{name}{w}" / co.TARGETS_REANALYZE).read_text().splitlines() for w in (1, 2))
            _expect_equal_lines(f"reanalyze {dtype} targets", a, b)
            others[f"reanalyze_{dtype}"] = {"equal": True, "targets": len(a)}
        wld = [[(x, y, r.wins, r.losses, r.draws) for x, y, r in res]
               for res in (single["evaluation"], ranks[0]["evaluation"]["result"])]
        if wld[0] != wld[1]:
            raise AssertionError(f"evaluation: world 2 scored {wld[1]}, world 1 {wld[0]}")
        others["evaluation"] = wld[1]
        got_p = [(r.category, r.attempted, r.solved, r.proven) for r in ranks[0]["puzzle"]["result"]]
        want_p = [(r.category, r.attempted, r.solved, r.proven) for r in single["puzzle"]]
        if got_p != want_p:
            raise AssertionError(f"puzzle: world 2 gave {got_p}, world 1 {want_p}")
        others["puzzle"] = got_p
        files = sorted(p.name for p in (d / "c1").iterdir() if not p.name.endswith(".ckpt"))
        if files != sorted(p.name for p in (d / "c2").iterdir() if not p.name.endswith(".ckpt")):
            raise AssertionError(f"coscheduled: world 2 wrote other files than world 1's {files}")
        for f in files:
            a, b = ((d / n / f).read_bytes() for n in ("c1", "c2"))
            if a != b:
                raise AssertionError(f"coscheduled {f}: world 2 differs from world 1")
        others["coscheduled_files"] = files
        if ranks[0]["coscheduled"]["result"]["model_steps"] != cos1["model_steps"]:
            raise AssertionError("coscheduled: world 2 trained another number of steps")
        same = {"reanalyze": lambda r: r["targets"], "reanalyze_f32": lambda r: r["targets"],
                "evaluation": lambda r: r, "puzzle": lambda r: r,
                "coscheduled": lambda r: (r["model_steps"], r["replays"], r["targets"])}
        for name, key in same.items():
            if key(ranks[1][name]["result"]) != key(ranks[0][name]["result"]):
                raise AssertionError(f"{name}: the ranks return different results")
        out["drivers"] = {**others, "seconds": [d1_s, d2_s],
                          "launches_per_rank": {n: [o[n]["launches"] for o in ranks] for n in per_rank}}
        log({"phase": "multi-device: reanalyze, evaluation, puzzle, coscheduled", **out["drivers"]})

    # (e) the scaling tool: 1x1 and 2x1 on this card under gloo.
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        scaling = multihost_scaling.main(["--configs", "1x1,2x1", "--backend", "gloo", "--steps", "24",
                                          "--chunk-steps", "4", "--repeats", "1", "--targets", "512",
                                          "--global-batch", "32"])
    out["scaling"] = {"rows": scaling, "seconds": time.perf_counter() - t0}
    log({"phase": "multi-device: multihost_scaling", **out["scaling"]})
    out["at_rank_selfplay"] = at_rank
    out["seconds"] = time.perf_counter() - t_phase
    log({"phase": "multi-device done", "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# Phase 17: the last JAX modules.
# ---------------------------------------------------------------------------

JAX_MODEL = Path(__file__).resolve().parent / "tests" / "data" / "jax_model_4x4.ckpt"
JAX_OUTPUTS = JAX_MODEL.with_name("jax_model_4x4_outputs.npz")
POOLS17 = {"pools": "776,3104", "sims": 32}  # 17d


def plain_parse_targets(n: int, text: str):
    """``parse_targets``'s outputs from the plain per-line parse
    (``Target.from_line``, ``tps_to_state``)."""
    import numpy as np
    import torch

    from takzero_torch.data.target import Target
    from takzero_torch.tak.tps import tps_to_state

    targets = [Target.from_line(n, line) for line in text.splitlines() if line.strip()]
    states = [tps_to_state(n, t.tps) for t in targets]
    return (type(states[0])(*(torch.stack(x) for x in zip(*states))),
            np.array([t.value for t in targets], np.float32), np.array([t.ube for t in targets], np.float32),
            np.array([a for t in targets for a, _ in t.policy], np.int32),
            np.array([p for t in targets for _, p in t.policy], np.float32),
            np.cumsum([0] + [len(t.policy) for t in targets]).astype(np.int64))


def check_native_loader(keep) -> dict:
    """17a: the C++ loader against the plain parse on phase 9's files (4x4):
    every target's state, value, UBE, actions and probabilities, and every
    replay's positions, equal; each parse timed on the host clock."""
    import numpy as np
    import torch

    from takzero_torch.config import NET_PRESETS
    from takzero_torch.data.native_loader import parse_replay_positions, parse_targets
    from takzero_torch.data.target import Replay
    from takzero_torch.parallel import coordinator as co
    from takzero_torch.tak.engine import engine

    cfg = NET_PRESETS["net4_simhash"]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    out = {"phase": "last modules: C++ target loader against the plain parse", "card": card_line()}
    for name in (co.TARGETS_SELFPLAY, co.TARGETS_REANALYZE):
        text = Path(keep, f"loop_{name}").read_text()
        t0 = time.perf_counter()
        native = parse_targets(eng.n, text)
        t1 = time.perf_counter()
        plain = plain_parse_targets(eng.n, text)
        t2 = time.perf_counter()
        for field in native[0]._fields:
            got = getattr(native[0], field)
            if not torch.equal(got, getattr(plain[0], field).to(got.dtype)):
                raise AssertionError(f"17a {name}: the C++ parse's {field} differs from the plain parse's")
        for i, (a, b) in enumerate(zip(native[1:], plain[1:])):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"17a {name}: output {i + 1} of the C++ parse differs from the plain parse's")
        out[name] = {"targets": int(len(native[1])), "cpp_ms": (t1 - t0) * 1e3, "plain_ms": (t2 - t1) * 1e3}
    lines = Path(keep, f"loop_{co.REPLAYS}").read_text().splitlines()
    t0 = time.perf_counter()
    states, plies = parse_replay_positions(eng.n, eng.half_komi, eng.reversible_limit, "\n".join(lines) + "\n")
    t1 = time.perf_counter()
    plain = [s for line in lines for s in Replay.from_line(eng.n, line).states(eng)]
    t2 = time.perf_counter()
    if len(plain) != len(plies) or not np.array_equal(plies, [int(s.ply) for s in plain]):
        raise AssertionError(f"17a replays: {len(plies)} positions from the C++ loader, {len(plain)} plain")
    for field in states._fields:
        want = torch.stack([getattr(s, field) for s in plain])
        if not torch.equal(getattr(states, field), want.to(getattr(states, field).dtype)):
            raise AssertionError(f"17a replays: the C++ loader's {field} differs from the plain explosion's")
    out[co.REPLAYS] = {"replays": len(lines), "positions": int(len(plies)), "cpp_ms": (t1 - t0) * 1e3,
                       "plain_ms": (t2 - t1) * 1e3}
    log(out)
    return out


def check_jax_checkpoint(dev) -> dict:
    """17b: the committed JAX checkpoint, loaded through the flax reader
    and evaluated on the card (float32, no TF32) to JAX's outputs within
    1e-4; kernel B once (read from the counter)."""
    import numpy as np
    import torch

    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.tak.engine import engine
    from takzero_torch.tak.tps import tps_to_state
    from takzero_torch.utils import ckpt

    want = np.load(JAX_OUTPUTS)
    cfg = NetConfig(n=int(want["n"]), half_komi=int(want["half_komi"]), filters=int(want["filters"]),
                    blocks=int(want["blocks"]), novelty=str(want["novelty"]), hash_bits=int(want["hash_bits"]),
                    compute_dtype=torch.float32)
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    t0 = time.perf_counter()
    bundle = ckpt.load_checkpoint(JAX_MODEL, new_agent(cfg, seed=0, device=dev))
    load_s = time.perf_counter() - t0
    states = [tps_to_state(cfg.n, str(t)) for t in want["tps"]]
    envs = type(states[0])(*(torch.stack(x).to(dev) for x in zip(*states)))
    zero_launches()
    got = make_net_evaluate(cfg, eng, device=dev)(bundle, envs)
    torch.cuda.synchronize()
    launches = _launches(*AB)
    if launches != {"exact_top_k_unsorted": 0, "simhash_pack": 1}:
        raise AssertionError(f"17b: launches {launches}, expected kernel B once")
    err = {}
    for g, name in zip(got, ("logits", "value", "variance")):
        g = g.float().cpu().numpy()
        err[name] = float(np.abs(g - want[name]).max())
        if not np.allclose(g, want[name], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"17b: {name} off JAX's by {err[name]}")
    out = {"phase": "last modules: a JAX checkpoint on the card", "card": card_line(), "file": str(JAX_MODEL.name),
           "bytes": JAX_MODEL.stat().st_size, "positions": len(states), "load_s": load_s, "max_abs_err": err,
           "launches": launches}
    log(out)
    return out


def check_noise_and_uct(dev) -> dict:
    """17c: Dirichlet noise and UCT scores on a searched 6x6 tree (128
    games, C=256, 32 simulations of the simple evaluator)."""
    import torch

    from takzero_torch.search import eval as ev
    from takzero_torch.search.agents import simple_evaluator
    from takzero_torch.search.core import make_simulate
    from takzero_torch.search.noise import apply_dirichlet, gamma_draws
    from takzero_torch.search.policy import uct_scores
    from takzero_torch.search.tree import init_tree
    from takzero_torch.tak.engine import engine

    eng = engine(6, half_komi=4)
    gen = torch.Generator(device=dev).manual_seed(17)
    tree = init_tree(eng, random_positions(eng, 128, 20, gen, dev), 40, 256)
    simulate = make_simulate(eng, simple_evaluator(eng))
    for _ in range(32):
        tree = simulate(tree, torch.zeros(128, device=dev))
    gamma = gamma_draws(gen, 0.3, (128, 256))
    noised = apply_dirichlet(tree, gamma, 0.25)
    visits = tree.root_visit.clone()
    scores = uct_scores(noised, visits, 0.5)
    valid = tree.child_action[:, 0, :] >= 0
    sums = noised.child_prob[:, 0, :].sum(-1)
    if not bool(((sums - 1).abs() < 1e-5).all()) or bool(noised.child_prob[:, 0, :][~valid].any()):
        raise AssertionError(f"17c: noised roots sum to {sums.min().item()}..{sums.max().item()}")
    pruned = (tree.child_flag[:, 0, :] == ev.WIN) & (tree.root_flag != ev.LOSS)[:, None]
    if not bool(torch.isfinite(scores[valid & ~pruned]).all()) or bool(torch.isfinite(scores[~valid]).any()):
        raise AssertionError("17c: UCT is not finite on exactly the valid unpruned slots")
    host = type(tree)(*(v.map(lambda x: x.cpu()) if hasattr(v, "map") else v.cpu() for v in tree))
    noised_cpu = apply_dirichlet(host, gamma.cpu(), 0.25)
    err = {"prob": float((noised.child_prob.cpu() - noised_cpu.child_prob).abs().max()),
           "logit": float((noised.child_logit.cpu() - noised_cpu.child_logit).abs().max())}
    scores_cpu = uct_scores(noised_cpu, visits.cpu(), 0.5)
    fin = torch.isfinite(scores_cpu)
    if not torch.equal(fin, torch.isfinite(scores.cpu())):
        raise AssertionError("17c: UCT's -inf slots differ between the card and the CPU")
    err["uct"] = float((scores.cpu()[fin] - scores_cpu[fin]).abs().max())
    if max(err.values()) > 1e-6:
        raise AssertionError(f"17c: the card and the CPU differ by {err}")
    out = {"phase": "last modules: Dirichlet noise and UCT", "card": card_line(), "games": 128, "simulations": 32,
           "valid_slots": int(valid.sum()), "pruned_slots": int((valid & pruned).sum()), "card_vs_cpu": err}
    log(out)
    return out


def run_pool_tools(dev) -> dict:
    """17d: ``pool_cliff --stub`` and ``phase_cliff`` at M = 776 and 3104,
    32 simulations; kernel A once a simulation with an ``apply_eval``."""
    from takzero_torch.tools import cliff_timing, phase_cliff, pool_cliff

    argv = ["--pools", POOLS17["pools"], "--sims", str(POOLS17["sims"]), "--device", str(dev)]
    n_pools, sims = len(POOLS17["pools"].split(",")), POOLS17["sims"]
    # Every M: a warm-up and a timed pass of ``sims`` simulations and a
    # profiled pass of a few; phase_cliff makes them for forward+apply_eval
    # and for the full simulation (forward alone expands nothing).
    per_pool = 2 * sims + min(sims, cliff_timing.PROFILE_SIMS)
    out = {"phase": "last modules: pool-size tools", "card": card_line()}
    t0 = time.perf_counter()
    launches = {}
    for name, main, extra, passes in (("pool_cliff", pool_cliff.main, ["--stub", "--reps", "1"], 1),
                                      ("phase_cliff", phase_cliff.main, [], 2)):
        zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rows = main(argv + extra)
        launches[name] = _launches(*AB)
        want = {"exact_top_k_unsorted": passes * per_pool * n_pools, "simhash_pack": 0}
        if launches[name] != want:
            raise AssertionError(f"17d {name}: launches {launches[name]}, expected {want}")
        out[name] = [{k: r[k] for k in ("M", "phase", "ms_per_sim", "kernels", "device_ms") if k in r} for r in rows]
    ms = {r["M"]: r["ms_per_sim"] for r in out["pool_cliff"]}
    lo, hi = sorted(ms)
    out["ms_per_sim_growth_per_doubling"] = (ms[hi] / ms[lo]) ** (1 / math.log2(hi / lo)) - 1
    out["launches"], out["seconds"] = launches, time.perf_counter() - t0
    log(out)
    return out


TOPK_IMPLS = ("pallas", "lax", "grouped", "exact_ref")
# Phase 18b's cut: k=64 makes 384 (k log2 k) the least budget; the
# flagship's is 768.  The random net's policy head is scaled by 1/20, so
# that its priors do not underflow to 0.0 (see run_topk_moves).
TOPK_MOVE = {"sampled": 64, "budget": 384, "policy_scale": 0.05}


def check_topk_impls(rows: dict, k: int = 256) -> dict:
    """18a: each of ``make_topk``'s impls on phase 3's f32[128, 9036]
    ``rows`` (masked logits and special rows) against ``topk_plain``: the values as
    a multiset bit for bit, the index sets equal on rows without a tie at
    the k-th value; on tied rows whether the order equals the stable
    sort's (the gate for ``lax``, whose contract it is), and the same for
    a bare ``torch.topk(sorted=True)`` (reported).  Each timed on the
    masked logits by phase 3's CUDA-graph method."""
    import torch

    from takzero_torch.ops import topk
    from takzero_torch.search.core import make_topk

    out = {"phase": "top-k impls (18a)", "card": card_line(), "k": k, "rows": {}, "us_per_call": {}}
    for what, x in rows.items():
        pv, pi = topk.topk_plain(x, k)
        kth = torch.sort(x, dim=-1, descending=True).values[:, k - 1:k]
        tied = (x == kth).sum(-1) > 1
        stable = torch.sort(-x, dim=-1, stable=True).indices[:, :k].to(torch.int32)
        row = {"shape": list(x.shape), "tied_rows": int(tied.sum())}
        for impl in TOPK_IMPLS:
            vals, idx = make_topk(impl)(x, k)
            bits = lambda v: torch.sort(v.contiguous().view(torch.int32), -1).values  # noqa: E731
            if not torch.equal(bits(vals), bits(pv)):
                raise AssertionError(f"18a {impl} ({what}): values differ from topk_plain's")
            same_set = (torch.sort(idx.long(), -1).values == pi.long()).all(-1)
            if not bool(same_set[~tied].all()):
                raise AssertionError(f"18a {impl} ({what}): index sets differ on untied rows "
                                     f"{(~same_set & ~tied).nonzero()[:, 0].tolist()}")
            if not torch.equal(x.gather(-1, idx.long()), vals):
                raise AssertionError(f"18a {impl} ({what}): indices do not point at their values")
            if impl in ("lax", "grouped"):
                ties_stable = bool((idx[tied] == stable[tied]).all())
                if not ties_stable:
                    raise AssertionError(f"18a {impl} ({what}): tied rows not in the stable sort's order")
                row[f"{impl}_tied_rows_equal_stable_sort"] = ties_stable
        bare = torch.topk(x, k, sorted=True).indices.to(torch.int32)
        row["torch_topk_tied_rows_equal_stable_sort"] = bool((bare[tied] == stable[tied]).all())
        out["rows"][what] = row
    x = rows["main-path rows"]
    for impl in TOPK_IMPLS:
        fn = make_topk(impl)
        out["us_per_call"][impl] = device_ms(lambda: fn(x, k))[0] * 1e3
    for sort in (False, True):
        out["us_per_call"][f"torch.topk sorted={sort}"] = device_ms(lambda: torch.topk(x, k, sorted=sort))[0] * 1e3
    out["us_per_call"]["kernel A call time"] = call_ms(lambda: topk.exact_top_k_unsorted(x, k)) * 1e3
    log(out)
    return out


def _place_by_action(noise, layout):
    """Per-action noise f32[B, A] placed in a tree's slot order (``layout``
    i32[B, C], -1 for an empty slot, whose noise is 0)."""
    import torch

    return torch.where(layout >= 0, noise.gather(1, layout.clamp(min=0).long()), 0.0)


def selection_tie_games(tree):
    """bool[B]: the games whose tree holds, below the root, a visited child
    whose prior equals a valid sibling's.  Unvisited siblings share their
    value and std, so such a child was picked from a tie of equal scores,
    which ``argmax`` gives to the lower slot, here as in JAX: the slot
    order, which the top-k impls set differently, decided it.  (At the
    root the Gumbel search forces every pick.)"""
    import torch

    rows = slice(1, tree.child_prob.shape[1] - 1)  # not the root, not the scratch row
    valid = (tree.child_action[:, rows] >= 0) & tree.node_live[:, rows, None]
    sentinel = -1.0 - torch.arange(valid.shape[-1], device=valid.device, dtype=torch.float32)
    prob, order = torch.sort(torch.where(valid, tree.child_prob[:, rows], sentinel), dim=-1)
    visited = tree.child_visit[:, rows].gather(-1, order) > 0
    tie = (prob[..., 1:] == prob[..., :-1]) & (visited[..., 1:] | visited[..., :-1])
    return tie.flatten(1).any(-1)


def run_topk_moves(dev, filters: int = 256, blocks: int = 16, batch: int = 128, hash_bits: int = 26,
                   sampled: int = TOPK_MOVE["sampled"], budget: int = TOPK_MOVE["budget"],
                   policy_scale: float = TOPK_MOVE["policy_scale"]) -> dict:
    """18b: one selfplay move at the flagship's widths (6x6, 16x256,
    SimHash 2^hash_bits, 128 games, C=256, tree reuse) in float32, under
    ``pallas``, ``lax`` and ``grouped`` in turn, each through the
    ``topk=`` argument from the same weights, openings and draws, after a
    warm-up move of each at k=2, budget 2.

    The root's Gumbel draws are per slot, in JAX as here, and the impls
    order the root's children differently, so the same draws would give
    the actions other noise.  Each impl gets the same per-action noise,
    placed in the slot order its expansion gives the root (predicted from
    one evaluation of the roots and checked against the searched tree).
    The random net's policy head is scaled by ``policy_scale``: unscaled,
    its logits span hundreds, most priors are exactly 0.0, and every game
    holds a selection tie among them (``selection_tie_games``), which
    leaves nothing to compare.
    Gates: the actions legal; on the games without a selection tie
    (``selection_tie_games`` under either impl, or a final pick between
    children of equal, maximal visits) the actions and the per-action root
    visits equal across impls and the root values within 1e-5; kernel A
    budget+1 launches under ``pallas`` and none otherwise, kernel B
    budget+1 under each.  Reported: the games with such a tie and how many
    of them split, wall seconds and CUDA-event milliseconds per move."""
    import dataclasses

    import torch

    from takzero_torch.config import NET_PRESETS, selfplay_preset
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.search.core import make_topk
    from takzero_torch.selfplay import SelfplayEngine, gumbel_noise, make_draws
    from takzero_torch.tak.engine import engine
    from takzero_torch.tools.cliff_timing import sync

    with float32_presets("net6_simhash"):
        cfg = dataclasses.replace(NET_PRESETS["net6_simhash"], filters=filters, blocks=blocks,
                                  hash_bits=hash_bits)
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    agent = new_agent(cfg, seed=0, device=dev)
    with torch.no_grad():
        for param in agent["net"].policy.parameters():
            param.mul_(policy_scale)
    agent.pop("folded")  # refolded on first use
    evaluate = make_net_evaluate(cfg, eng, device=dev)
    sp_cfg = selfplay_preset("net6_simhash", batch=batch, sampled_actions=sampled, search_budget=budget,
                             tree_reuse=True)
    c, a = sp_cfg.max_children, eng.num_actions
    gen = torch.Generator(device=dev).manual_seed(18)
    draws = make_draws(gen, batch, c)
    noise = {"gumbel_root": gumbel_noise(gen, (batch, a)), "gumbel_sample": gumbel_noise(gen, (batch, a))}
    out = {"phase": "top-k impls: one move each (18b)", "card": card_line(), "net": net_label(cfg),
           "dtype": "float32", "batch": batch, "sampled": sampled, "budget": budget, "children": c,
           "cut": f"budget {budget} (flagship 768), float32 (flagship bf16)", "policy_scale": policy_scale,
           "impls": {}}
    results = {}
    t_phase = time.perf_counter()
    for impl in ("pallas", "lax", "grouped"):
        warm = SelfplayEngine(eng, dataclasses.replace(sp_cfg, sampled_actions=2, search_budget=2), evaluate,
                              device=dev, topk=impl)
        warm.reset(draws)
        warm.move(warm.envs, warm.tree, agent, draws)
        sp = SelfplayEngine(eng, sp_cfg, evaluate, device=dev, topk=impl)
        sp.reset(draws)
        logits, _, _ = evaluate(agent, sp.envs)
        masked = torch.where(eng.legal_mask(sp.envs), logits.float(), NEG).contiguous()
        vals, idx = make_topk(impl)(masked, c)
        layout = torch.where(vals > NEG / 2, idx, -1)
        move_draws = dict(draws, **{key: _place_by_action(v, layout) for key, v in noise.items()})
        tree_in = sp.tree
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda" else []
        sync(dev)
        zero_launches()
        t0 = time.perf_counter()
        for event in events[:1]:
            event.record()
        _, _, packed, root = sp.move(sp.envs, tree_in, agent, move_draws)
        packed = packed.cpu()  # the actor's one readback
        for event in events[1:]:
            event.record()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = _launches(*AB)
        want = {"exact_top_k_unsorted": budget + 1 if impl == "pallas" else 0, "simhash_pack": budget + 1}
        if launches != want:
            raise AssertionError(f"18b {impl}: launches {launches}, expected {want}")
        if not torch.equal(root["action"], layout):
            raise AssertionError(f"18b {impl}: the searched root's slot order differs from the predicted one")
        action = packed[:, 0].long()
        legal = eng.legal_mask(sp.envs).gather(1, action.to(dev)[:, None])[:, 0]
        if not bool(legal.all()):
            raise AssertionError(f"18b {impl}: illegal actions in lanes {(~legal).nonzero()[:, 0].tolist()}")
        visits = torch.zeros((batch, a + 1), dtype=torch.int32, device=dev)
        visits.scatter_(1, torch.where(layout >= 0, layout, a).long(), root["visit"])
        results[impl] = {"action": action, "visits": visits[:, :a].cpu(), "root_value": tree_in.root_value.cpu(),
                         "ties": selection_tie_games(tree_in).cpu()}
        out["impls"][impl] = {"s_per_move": wall, "launches": launches,
                              "event_ms_per_move": events[0].elapsed_time(events[1]) if events else None}
    ref = results["pallas"]
    for impl in ("lax", "grouped"):
        got = results[impl]
        # Where no root child reaches the sampling threshold, the move takes
        # the most visited child, and a tie among them goes to the lower
        # slot (``select_best_slot``, JAX's ``argmax`` too).
        top = ref["visits"].max(-1).values
        final_tie = (got["action"] != ref["action"]) & \
            (ref["visits"].gather(1, ref["action"][:, None])[:, 0] == top) & \
            (ref["visits"].gather(1, got["action"][:, None])[:, 0] == top)
        tied = ref["ties"] | got["ties"] | final_tie
        split = (got["action"] != ref["action"]) | (got["visits"] != ref["visits"]).any(-1)
        if bool((split & ~tied).any()):
            raise AssertionError(f"18b {impl}: actions or per-action root visits differ from pallas's in games "
                                 f"{(split & ~tied).nonzero()[:, 0].tolist()}, which hold no selection tie")
        if not bool((~tied).any()):
            raise AssertionError(f"18b {impl}: every game holds a selection tie; nothing is compared")
        gap = float((got["root_value"] - ref["root_value"])[~tied].abs().max())
        if not gap <= 1e-5:
            raise AssertionError(f"18b {impl}: root values {gap} from pallas's (limit 1e-5)")
        out["impls"][impl].update(games_compared=int((~tied).sum()), games_with_a_selection_tie=int(tied.sum()),
                                  tie_games_split=int((split & tied).sum()), root_value_gap_to_pallas=gap)
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    return out


def run_topk_ab(dev, rows: dict) -> dict:
    """Phase 18: 18a on phase 3's ``rows``, 18b and the ``topk_ab`` line."""
    impls = check_topk_impls(rows)
    moves = run_topk_moves(dev)
    calls = moves["budget"] + 1  # one expansion a simulation, under every impl
    ab = {"phase": "topk_ab", "card": card_line(), "budget": moves["budget"], "impls": {}}
    for impl, move in moves["impls"].items():
        us = impls["us_per_call"][impl]
        ab["impls"][impl] = {"us_per_call": us, "s_per_move": move["s_per_move"],
                             "event_ms_per_move": move["event_ms_per_move"],
                             "topk_device_ms_per_move": us * calls / 1e3}
    log(ab)
    return {"impls": impls, "moves": moves, "ab": ab}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    if os.environ.get("TAKZERO_TOPK"):
        print(f"chip_smoke: TAKZERO_TOPK={os.environ['TAKZERO_TOPK']!r} is set; every phase gates kernel A's "
              "launches on the default impl (pallas), and phase 18 chooses each impl through topk=, so unset it",
              file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "takzero_torch").is_dir():
        print("chip_smoke: run from the repository root (takzero_torch/ not found)", file=sys.stderr)
        return 1
    kernels_only = "--kernels-only" in sys.argv[1:]
    from takzero_torch.ops import _build
    from takzero_torch.tak.engine import engine

    float32_without_tf32()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log(card_line())
    log({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_kernel = _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": per_kernel})

    gen = torch.Generator(device=dev).manual_seed(0)
    eng = engine(6, half_komi=4)
    envs = random_positions(eng, 128, 40, gen, dev)
    topk_out = check_topk(eng, envs, gen, dev)
    simhash_out = check_simhash(eng, envs, gen, dev)
    tree_out = check_tree_kernels(dev)
    conv_out = check_conv_kernel(dev)
    if kernels_only:
        log({"phase": "done", "seconds": time.perf_counter() - t_start, "kernels_only": True})
        return 0
    topk_8x8 = check_topk_8x8(gen, dev)
    search_8x8 = run_search_8x8(dev, gen)
    check_small_reference(dev)
    launches, _ = run_main_path(dev)
    check_learner_small_reference(dev)
    learner_launches = run_learner_main_path(dev)
    at_4x4 = check_kernels_4x4(gen, dev)
    keep = tempfile.mkdtemp(prefix="takzero_smoke_files_")  # phases 9 and 11's files, for phase 14
    try:
        loop = run_actor_loop(dev, keep=keep)
        serve = run_serve_path(dev, gen)
        cosched = run_coscheduled(dev, keep=keep)
        tiny = run_tiny_run(dev)
        t13 = time.perf_counter()
        check_novelty_small_reference(dev)
        rnd_loop = run_actor_loop(dev, net="net4_rnd")  # 13b: phase 9's loop and cuts
        lcg = run_lcghash_drivers(dev)
        topk_5x5 = check_topk_5x5(gen, dev)
        ens_net5 = run_ensemble_and_net5(dev)
        log({"phase": "novelty variants done", "seconds": time.perf_counter() - t13})
        eee = run_eee_and_visualizers(dev, keep)
        check_native_loader(keep)  # 17a, on phase 9's files
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    tools = run_oracle_and_tools(dev)
    multi = run_multi_device(dev)
    t17 = time.perf_counter()
    jax_ckpt = check_jax_checkpoint(dev)
    check_noise_and_uct(dev)
    pool_tools = run_pool_tools(dev)
    log({"phase": "last modules done", "seconds": time.perf_counter() - t17})
    topk_ab = run_topk_ab(dev, topk_out["rows"])

    kernels = []
    for name, out, source, replaces in (
        ("exact_top_k_unsorted", topk_out, "takzero_torch/csrc/topk.cu", "takzero_tpu/ops/topk.py:57"),
        ("simhash_pack", simhash_out, "takzero_torch/csrc/simhash.cu",
         "takzero_tpu/ops/pallas_kernels.py:25"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "checked": True, "launches": launches[name], "learner_launches": learner_launches[name],
            "selfplay_driver_launches": loop["launches"]["selfplay_driver"][name],
            "reanalyze_launches": loop["launches"]["reanalyze"][name], "at_4x4": at_4x4[name],
            "max_abs_err": out["max_abs_err"],
            "ms": out["kernel_ms"], "call_ms": out["call_ms"], "plain_ms": out["plain_ms"],
            "bound_ms": out["bound_ms"], "bound_by": out["bound_by"], "library_ms": out["library_ms"],
            "tei_launches": serve["tei"]["launches"][name], "analysis_launches": serve["analysis"]["launches"][name],
            "evaluation_launches": serve["evaluation"]["launches"][name],
            "puzzle_launches": serve["puzzles"]["launches"][name],
            "serve_shape": serve["kernels"][name]["shape"], "serve_ms": serve["kernels"][name]["kernel_ms"],
            "serve_call_ms": serve["kernels"][name]["call_ms"], "serve_bound_ms": serve["kernels"][name]["bound_ms"],
            "serve_plain_ms": serve["kernels"][name]["plain_ms"],
            "serve_library_ms": serve["kernels"][name]["library_ms"],
            "search_8x8_launches": search_8x8["launches"][name],
            "coscheduled_launches": cosched["launches"][name],
            "coscheduled_launches_per_move": cosched["launches_per_move"][name],
            "tiny_run_launches": tiny["launches"][name],
            "tiny_run_launches_per_iteration": tiny["launches_per_iteration"][name],
            "rnd_loop_selfplay_driver_launches": rnd_loop["launches"]["selfplay_driver"][name],
            "rnd_loop_reanalyze_launches": rnd_loop["launches"]["reanalyze"][name],
            "lcghash_launches_per_move": lcg["launches_per_move"][name],
            "ensemble_launches_per_move": ens_net5["net4_ensemble"]["launches_per_move"][name],
            "net5_launches_per_move": ens_net5["net5"]["launches_per_move"][name],
        })
    kernels[0]["at_5x5"] = {k: topk_5x5[k] for k in ("shape", "k", "kernel_ms", "call_ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by")}
    kernels[0]["at_8x8"] = {k: topk_8x8[k] for k in ("shape", "k", "kernel_ms", "call_ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "adversarial_rows_kernel_ms")}
    # Phase 14, each launch count read from the counters in this run.
    gen_steps, plies, sims = (eee["generalization"]["simhash"]["steps"], eee["seen_ratio"]["plies"],
                              2 * eee["visualize_search"]["visits"])
    for entry in kernels:
        name = entry["name"]
        entry["eee_generalization_launches_per_step"] = eee["generalization"]["simhash"]["launches"][name] / gen_steps
        entry["eee_generalization_lcghash_launches"] = eee["generalization"]["lcghash"]["launches"][name]
        entry["seen_ratio_launches_per_ply"] = eee["seen_ratio"]["launches"][name] / plies
        entry["visualize_search_launches_per_simulation"] = eee["visualize_search"]["launches"][name] / sims
    kernels[0]["at_1x944"] = eee["visualize_search"]["at_1x944"]
    kernels[1]["at_seen_ratio"] = eee["seen_ratio"]["at_seen_ratio"]
    kernels[1]["at_eee_generalization"] = eee["generalization"]["at_eee_generalization"]
    # Phase 15, each launch count read from the counters in this run.
    for entry in kernels:
        name = entry["name"]
        entry["prover_launches_per_solve"] = tools["puzzles"]["launches_per_solve"][name]
        entry["reuse_ab_launches_per_half_move"] = tools["reuse_ab"]["launches_per_half_move"][name]
    kernels[0]["at_prover"] = tools["puzzles"]["at_prover"]
    kernels[1]["at_reuse_ab"] = tools["reuse_ab"]["at_reuse_ab"]
    # Phase 16: each rank's counters (two gloo ranks on this card).
    kernels[1]["at_rank_learner"] = multi["learner"]["at_rank_learner"]
    for entry in kernels:
        name = entry["name"]
        entry["at_rank_selfplay"] = multi["at_rank_selfplay"][name]
        entry["launches_per_rank"] = {
            "learner": [c[name] for c in multi["learner"]["launches_per_rank"]],
            "selfplay": [c[name] for c in multi["selfplay"]["launches_per_rank"]],
            **{k: [c[name] for c in v] for k, v in multi["drivers"]["launches_per_rank"].items()},
        }
        entry["learner_allreduce_ms"] = {"world1_nccl": multi["learner"]["allreduce_ms_world1_nccl"],
                                         "world2_gloo_one_card": multi["learner"]["allreduce_ms_world2_gloo"]}
        # Phase 17, read from the counters in this run.
        entry["jax_checkpoint_launches"] = jax_ckpt["launches"][name]
        entry["pool_tools_launches"] = {k: v[name] for k, v in pool_tools["launches"].items()}
        # Phase 18b: one move under each top-k impl, read from the counters.
        entry["topk_ab_launches_per_move"] = {k: v["launches"][name] for k, v in topk_ab["moves"]["impls"].items()}
    kernels[0]["topk_impls_us_per_call"] = topk_ab["impls"]["us_per_call"]
    # The descent, settle, expansion and backup kernels: their launches on
    # the paths that check them, read from the counters in this run, and
    # phase 4b.
    apply_eval = "takzero_tpu/search/core.py:305 (apply_eval with legal_mask, fused)"
    for name, walk, source, replaces in (
            ("tree_descend", "descend", "tree", "takzero_tpu/search/core.py:101 (a batched loop)"),
            ("tree_settle", "settle", "settle", "takzero_tpu/search/core.py:101 (forward's fused tail)"),
            ("expand_mask", "expand_mask", "expand", apply_eval),
            ("expand_store", "expand_store", "expand", apply_eval),
            ("tree_backup", "backup", "tree", "takzero_tpu/search/core.py:430 (a batched loop)")):
        kernels.append({
            "name": name, "route": "cuda", "source": f"takzero_torch/csrc/{source}.cu", "replaces": replaces,
            "checked": True, "launches": launches[name],
            "selfplay_driver_launches": loop["launches"]["selfplay_driver"][name],
            "reanalyze_launches": loop["launches"]["reanalyze"][name],
            "tei_launches": serve["tei"]["launches"][name], "analysis_launches": serve["analysis"]["launches"][name],
            "evaluation_launches": serve["evaluation"]["launches"][name],
            "puzzle_launches": serve["puzzles"]["launches"][name],
            "at_6x6": tree_out[f"{walk}_6x6"], "at_5x5": tree_out[f"{walk}_5x5"],
        })
    # The convolution kernel: its launches on the paths that check them,
    # read from the counters in this run, and phase 4c.
    name = "conv3x3"
    kernels.append({
        "name": name, "route": "cuda", "source": "takzero_torch/csrc/conv.cu",
        "replaces": "none (XLA's convolutions, takzero_tpu/models/network.py apply_folded)", "checked": True,
        "launches": launches[name], "search_8x8_launches": search_8x8["launches"][name],
        "selfplay_driver_launches": loop["launches"]["selfplay_driver"][name],
        "reanalyze_launches": loop["launches"]["reanalyze"][name],
        "rnd_loop_selfplay_driver_launches": rnd_loop["launches"]["selfplay_driver"][name],
        "rnd_loop_reanalyze_launches": rnd_loop["launches"]["reanalyze"][name],
        "tei_launches": serve["tei"]["launches"][name], "analysis_launches": serve["analysis"]["launches"][name],
        "evaluation_launches": serve["evaluation"]["launches"][name],
        "puzzle_launches": serve["puzzles"]["launches"][name],
        "lcghash_launches_per_move": lcg["launches_per_move"][name],
        "ensemble_launches_per_move": ens_net5["net4_ensemble"]["launches_per_move"][name],
        "net5_launches_per_move": ens_net5["net5"]["launches_per_move"][name],
        "visualize_search_launches_per_simulation": eee["visualize_search"]["launches"][name] / sims,
        "reuse_ab_launches_per_half_move": tools["reuse_ab"]["launches_per_half_move"][name],
        "launches_per_rank": {
            "selfplay": [c[name] for c in multi["selfplay"]["launches_per_rank"]],
            **{k: [c[name] for c in v] for k, v in multi["drivers"]["launches_per_rank"].items()},
        },
        "at_6x6": conv_out["6x6"], "at_5x5": conv_out["5x5"],
    })
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    log(card_line())
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
