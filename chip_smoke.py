"""Smoke test of the PyTorch/CUDA port (``takzero_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--kernels-only]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
It imports nothing of JAX or of ``takzero_tpu``.  Phases, in order:

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
3b. kernel A on rows too wide for shared memory (after phase 4, so that
   ``--kernels-only`` still times earlier designs): 8x8's f32[128, 65216]
   on masked logits of random 8x8 positions and on the adversarial rows,
   with k=1, 256 and A, values bit for bit and indices exactly; device
   time, call time, bound, plain time and ``torch.topk``'s at k=256;
3c. the Gumbel search at 8x8: the small net of
   ``tests/test_torch_bigboards.py`` on the card against the CPU (trees
   equal, floats within 1e-4), then one search at 16x256 bf16 with SimHash
   over 2^32 bits (128 games, k=8, budget 24, C=256): actions legal, the
   root-visit invariant, both kernels budget+1 launches;
5. a small reference check: the 3x3 move program (dummy evaluator), the
   small network in float32 and in bf16 on the card against the same on
   the CPU, and one bf16 convolution at the flagship width against
   float64 (the convolutions' float32 accumulation);
6. the main path: ``takzero_torch.bench`` at the flagship configuration
   (6x6, 16x256 bf16 net, SimHash 2^26, batch 128, k=64, budget 768,
   C=256, tree reuse), one warm-up move and one timed move (cut from the
   bench's two to keep the smoke inside its time).  Both kernels'
   launch counters are set to 0 before and must read (budget+1) per move
   after; chosen actions must be legal and tree values finite;
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
   count other than (budget+1) per selfplay move and per reanalyze step,
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
   tree reused (the descended root keeps the child's visits), each kernel
   launched exactly twice per chunk; (c) ``serve_bench`` with its defaults
   (nodes/s, seconds per chunk, peak device memory) beside TEI's own nps;
   (d) one analysis chunk on a fresh tree: 128 root visits, one table row
   per valid root child, kernel A 128 launches and B 2; (e) the evaluation
   driver with ``--pair`` at net4_simhash on two checkpoints of
   ``new_agent`` seeds 1 and 2 (32 games, k=4, budget 8, 25 moves a side:
   depth cut): both log lines parse as the Elo tooling parses them, W+L+D
   <= games, both kernels (budget+1) launches per half-move; (f) the puzzle
   driver at net6_simhash on the repository's ``examples/puzzles_6x6.db``
   (238 puzzles, every category: tinue at depths 3/5/7/9, avoidance at
   2/4/6; 7 batches of up to 64; k=8, budget 24): every puzzle attempted,
   (budget+1) launches per batch, solved and proven reported per depth
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
   ``tools.make_puzzles`` at 6x6 (16 games, batch 64, budget 256, C=128,
   no deep pass, 20,000 verifier nodes, target 2, 40 s): kernel A budget+1
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
16. a ``kernels`` JSON line: each kernel with what it replaces, its
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
   [64, 1296] x [1296, 32] (``at_reuse_ab``).

Device time per call: 50 calls of the wrapper captured in one CUDA graph,
the graph replayed 20 times between two CUDA events (the profiler's summed
kernel time if capture fails; the phase line says which).  Call time per
call: 200 back-to-back calls of the wrapper after 20 warm-up calls, between
two CUDA events, which is what the main path pays with the host in the
loop.  ``--kernels-only`` stops after phase 4 (a short call, or a checkout
of an earlier design of the kernels).

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises,
so the script exits non-zero and prints no such line; without a CUDA card
it exits with 1 at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory bandwidth,
# float32 outside the tensor cores, and TF32 in them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12  # tensor cores, dense
NEG = -3.0e38


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
        search = make_gumbel_search(eng, lambda e: evaluate(agent, e), 4, 16, max_depth=16)
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
    search = make_gumbel_search(eng, lambda e: evaluate(agent, e), k, budget, max_depth=48)
    tree = init_tree(eng, envs, budget + 8, children)
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    tree, slot = search(tree, gumbel_noise(gen, (batch, children)), torch.zeros(batch, device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _expect_launches("8x8 search at 16x256", budget + 1, 1)
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

    # One bf16 convolution at the flagship width against float64: the
    # products of bf16 values are exact in TF32 and float32, so the card's
    # error must stay at float32 summation level (a Winograd or FFT
    # algorithm would not).
    gen = torch.Generator().manual_seed(5)
    xc = torch.randn(32, 256, 6, 6, generator=gen).to(torch.bfloat16)
    wc = (torch.randn(256, 256, 3, 3, generator=gen) / 48).to(torch.bfloat16)
    bias = torch.zeros(256)
    with conv_precision(torch.bfloat16):
        got = _conv2d(xc.to(dev), wc.to(dev), bias.to(dev), torch.bfloat16).cpu().double()
    ref = torch.nn.functional.conv2d(xc.double(), wc.double(), padding=1)
    scale = torch.nn.functional.conv2d(xc.double().abs(), wc.double().abs(), padding=1)
    rel = float(((got - ref).abs() / scale.clamp(min=1e-30)).max())
    report["conv_bf16_vs_float64"] = {"max_err_over_sum_abs_products": rel, "limit": 1e-5}
    log(report)
    if rel > 1e-5:
        raise AssertionError(f"bf16 convolution on the card: error {rel:.3g} of sum|x*w| > 1e-5")


def run_main_path(dev) -> tuple[dict, object]:
    import torch

    from takzero_torch import bench
    from takzero_torch.ops import simhash, topk
    from takzero_torch.tak.engine import engine

    # The flagship configuration, one timed move after the warm-up (the
    # bench's default is two: cut to keep the smoke inside its time).
    cfg = bench.BenchConfig(moves=1)
    topk.exact_top_k_unsorted.launches = 0
    simhash.simhash_pack.launches = 0
    res = bench.run(cfg, device=dev)
    launches = {
        "exact_top_k_unsorted": topk.exact_top_k_unsorted.launches,
        "simhash_pack": simhash.simhash_pack.launches,
    }
    expect = (cfg.budget + 1) * (cfg.moves + 1)  # the warm-up move included
    for name, count in launches.items():
        if count != expect:
            raise AssertionError(f"{name}: {count} launches on the main path, expected {expect}")

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
    from takzero_torch.ops import simhash, topk
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
        topk.exact_top_k_unsorted.launches = 0
        simhash.simhash_pack.launches = 0
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
        launches = {"exact_top_k_unsorted": topk.exact_top_k_unsorted.launches,
                    "simhash_pack": simhash.simhash_pack.launches}
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


def _launch_counts() -> dict:
    from takzero_torch.ops import simhash, topk

    return {"exact_top_k_unsorted": topk.exact_top_k_unsorted.launches,
            "simhash_pack": simhash.simhash_pack.launches}


def _zero_launch_counts() -> None:
    from takzero_torch.ops import simhash, topk

    topk.exact_top_k_unsorted.launches = 0
    simhash.simhash_pack.launches = 0


def _expect_launches(what: str, per: int, count: int, b_per: int | None = None) -> dict:
    """Read the counters; kernel A must have launched ``per * count`` times
    and kernel B ``b_per * count`` (``b_per`` defaults to ``per``; 0 for a
    net without SimHash)."""
    got = _launch_counts()
    want = {"exact_top_k_unsorted": per, "simhash_pack": per if b_per is None else b_per}
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
    b_per = per_move if cfg.novelty == "simhash" else 0
    hashed = cfg.novelty in ("simhash", "lcghash")
    b_in_phase = 0  # kernel B's launches over the whole phase

    def zero_counts():
        nonlocal b_in_phase
        b_in_phase += _launch_counts()["simhash_pack"]
        _zero_launch_counts()

    _zero_launch_counts()  # earlier phases' launches are not this phase's
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
        sp_launches = _expect_launches("selfplay driver", per_move, sp["moves"], b_per)
        # 3. Ten learner steps on the selfplay targets.
        lr = learn.main(learner + ["--seed", "2", "--pretrain-steps", "0", "--max-steps", "10"])
        if lr["steps"] != 10:
            raise AssertionError(f"the learner took {lr['steps']} steps on selfplay targets, expected 10")
        # 4. Two more moves: one reload, and the seen-set of the whole log.
        zero_counts()
        sp2 = selfplay.main(common + search + ["--seed", "3", "--max-steps", "2"])
        _expect_launches("selfplay driver, 2 moves", per_move, 2, b_per)
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
        re_launches = _expect_launches("reanalyze", per_move, re["steps"], b_per)
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
    import takzero_torch.search.serve as serve
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

    saved = core.exact_top_k_unsorted, serve.exact_top_k_unsorted, agent.simhash_pack
    core.exact_top_k_unsorted = serve.exact_top_k_unsorted = rec_a
    agent.simhash_pack = rec_b
    try:
        yield
    finally:
        core.exact_top_k_unsorted, serve.exact_top_k_unsorted, agent.simhash_pack = saved


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

    _zero_launch_counts()
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
    launches = _expect_launches("TEI", 2, chunks)
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
    _zero_launch_counts()
    t0 = time.perf_counter()
    tree = run(tree)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    want = {"exact_top_k_unsorted": analysis.SIM_CHUNK, "simhash_pack": 2}
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
        _zero_launch_counts()
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
    launches = _expect_launches("evaluation driver", budget + 1, half_moves)
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
        _zero_launch_counts()
        t0 = time.perf_counter()
        results = puzzle.main(["--model", str(model), "--puzzle-db", str(PUZZLE_DB), "--net", "net6_simhash",
                               "--depths", "3,5,7,9", "--avoidance-depths", "2,4,6",
                               "--sampled-actions", str(sampled), "--search-budget", str(budget),
                               "--device", str(dev)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    batches = sum(math.ceil(n / puzzle.BATCH_SIZE) for n in PUZZLE_COUNTS.values())
    launches = _expect_launches("puzzle driver", budget + 1, batches)
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
        self.snaps.append((_launch_counts(), 0))
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
        _zero_launch_counts()
        draws = _CountingDraws(torch.Generator(device=dev).manual_seed(0))
        out = coscheduled.main(argv, draws=draws)
        torch.cuda.synchronize()
        launches = _launch_counts()
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
        _zero_launch_counts()
        t0 = time.perf_counter()
        res = tiny_run.main(["--iters", str(iters), "--eval-games", str(eval_games), "--out", f"{d}/tiny_run.json",
                             "--device", str(dev)], on_iteration=lambda it: snaps.__setitem__(it, _launch_counts()))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
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
        _zero_launch_counts()
        learn.main(learner + ["--seed", "0", "--pretrain-targets", str(10 * batch), "--pretrain-steps", "10",
                              "--max-steps", "0"])
        _expect_launches("net4_lcghash learner pre-training", 0, 1)
        log_after_pre = ckpt.read_hash_indices(f"{d}/{ckpt.HASH_LOG}", 0)[0].size
        sp = selfplay.main(common + search + ["--seed", "1", "--max-steps", "4"])
        sp_launches = _expect_launches("net4_lcghash selfplay", per, 4, 0)
        eng = engine(cfg.n, half_komi=cfg.half_komi)
        lines = [t.to_line() for t in random_pretraining_targets(eng, 4 * batch, np.random.default_rng(3), device=dev)]
        Path(d, co.TARGETS_SELFPLAY).write_text("\n".join(lines) + "\n", encoding="utf-8")
        _zero_launch_counts()
        lr = learn.main(learner + ["--seed", "2", "--pretrain-steps", "0", "--max-steps", "4"])
        _expect_launches("net4_lcghash learner", 0, 1)
        sp2 = selfplay.main(common + search + ["--seed", "3", "--max-steps", "2"])
        _expect_launches("net4_lcghash selfplay, 2 moves", per, 2, 0)
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
            _zero_launch_counts()
            try:
                lr = learn.main(common + ["--batch-size", str(batch), "--no-wait", "--seed", "0",
                                          "--pretrain-targets", str(2 * batch), "--pretrain-steps", "2",
                                          "--max-steps", "0"])
            finally:
                logging.getLogger("learn").removeHandler(handler)
            _expect_launches(f"{net} learner", 0, 1)
            warned = any("NOT trained" in w for w in warnings)
            if warned != (cfg.novelty == "ensemble"):
                raise AssertionError(f"{net}: ensemble warning {'given' if warned else 'missing'}: {warnings}")
            sp = selfplay.main(common + ["--batch", str(batch), "--sampled", str(sampled), "--budget", str(budget),
                                         "--seed", "1", "--max-steps", "1"])
            launches = _expect_launches(f"{net} selfplay move", per, 1, 0)
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
                _zero_launch_counts()
                lr = learn.main(common + ["--batch-size", str(batch), "--no-wait", "--seed", "2",
                                          "--pretrain-steps", "0", "--max-steps", "2"])
                _expect_launches("net5 learner", 0, 1)
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
        _zero_launch_counts()
        t0 = time.perf_counter()
        with recording_kernel_inputs(calls, last=8), contextlib.redirect_stdout(io.StringIO()):
            rows = generalization.run(replays, csv, n=4, half_komi=4, novelty=novelty, hash_bits=26, steps=n_steps,
                                      batch_size=256, device=dev, report=report)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
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
    _zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = rnd.run(replays, csv, n=4, half_komi=4, steps=steps, batch_size=256, device=dev, report=report)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _expect_launches("EEE rnd", 0, 1)
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
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = ensemble.run(targets, csv, n=4, half_komi=4, steps=steps, batch_size=128, device=dev, report=report)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _expect_launches("EEE ensemble", 0, 1)
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
        _zero_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with recording_kernel_inputs(calls, last=2), contextlib.redirect_stdout(io.StringIO()):
            pairs = eee.main(["seen-ratio", "--model", str(model), "--net", "net6_simhash", "--max-ply", str(plies),
                              "--batch", str(batch), "--device", str(dev), "--csv", str(Path(out, "seen_ratio.csv"))])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        launches = _launch_counts()
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
    _zero_launch_counts()
    t0 = time.perf_counter()
    with recording_kernel_inputs(calls), contextlib.redirect_stdout(io.StringIO()):
        drawn = visualize_search.main(["--net", "net4_rnd", "--visits", str(visits), "--betas", "0,1",
                                       "--out-dir", str(out), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _expect_launches("visualize_search", 1, 2 * visits, 0)
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
    """15b: ``tools.make_puzzles`` at 6x6, full width, depth cut: 16 games,
    batch 64, budget 256, C=128, no deep pass, 20,000 verifier nodes,
    target 2, 40 s.  Kernel A must launch budget + 1 times a solve (the
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
    _zero_launch_counts()
    mp.make_solver = timed_solver
    try:
        with recording_kernel_inputs(calls, last=PROVER_BUDGET + 1):
            res = mp.main(["--out", str(db), "--size", "6", "--games", "16", "--budget", str(PROVER_BUDGET),
                           "--batch", str(PROVER_BATCH), "--max-children", str(PROVER_CHILDREN),
                           "--deep-budget", "0", "--verify-nodes", str(VERIFY_NODES), "--target", "2",
                           "--time-limit", "40", "--seed", "0", "--device", str(dev)])
    finally:
        mp.make_solver = real
    torch.cuda.synchronize()
    if res["solves"] < 1 or len(solve_s) != res["solves"]:
        raise AssertionError(f"make_puzzles: {res['solves']} solves, {len(solve_s)} timed")
    launches = _expect_launches("make_puzzles prover", PROVER_BUDGET + 1, res["solves"], b_per=0)
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
           "cuts": {"games": 16, "budget": PROVER_BUDGET, "batch": PROVER_BATCH, "max_children": PROVER_CHILDREN,
                    "deep_budget": 0, "verify_nodes": VERIFY_NODES, "target": 2, "time_limit": 40},
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
    _zero_launch_counts()
    with recording_kernel_inputs(calls, last=2 * (REUSE_AB_BUDGET + 1)):
        summary = reuse_ab.main(["--ckpt", str(model), "--net", "net6_simhash", "--budget", str(REUSE_AB_BUDGET),
                                 "--sampled", "8", "--max-moves", "4", "--device", str(dev)])
    torch.cuda.synchronize()
    half = summary["half_moves"]
    launches = _expect_launches("reuse_ab", REUSE_AB_BUDGET + 1, half)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "takzero_torch").is_dir():
        print("chip_smoke: run from the repository root (takzero_torch/ not found)", file=sys.stderr)
        return 1
    kernels_only = "--kernels-only" in sys.argv[1:]
    from takzero_torch.ops import _build
    from takzero_torch.tak.engine import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    tools = run_oracle_and_tools(dev)

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
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    log(card_line())
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
