"""The port's drivers over several ranks: world 2 against world 1.

World 1 of the port is held to JAX by the other ``tests/test_torch_*.py``;
here each driver runs with ``--devices 2 --device cpu`` (two spawned gloo
ranks, a ``file://`` rendezvous in a temporary directory, at most two CPU
threads each) and with no ``--devices`` on the same inputs, as
``tests/test_driver_multidevice.py`` holds JAX's ``--devices 8`` to one
device:

* ``selfplay`` (tiny3, batch 8, budget 16, k 4, 25 moves): ``replays.txt``,
  ``targets-selfplay.txt`` and the ``--dump-search`` file byte for byte;
* ``learn`` (3 steps on selfplay targets): the metrics within 1e-3 on the
  first step and within 0.2 after it (JAX's tolerances: bf16 rounding
  drift grows step by step), each step's line written once, ``hash_log.bin``
  byte for byte and the seen-set equal to the one rebuilt from it;
* ``reanalyze``, ``evaluation`` (W/L/D) and ``puzzle`` (the results on the
  repository's 6x6 sample database): equal to world 1;
* ``coscheduled``: ``replays.txt``, ``hash_log.bin`` and the other text
  files byte for byte; the targets' positions, actions and values too, and
  their probabilities within 5e-2 (the trained bf16 weights round apart
  after the first step, as the learner's do).

Then the launcher: ``drivers.multihost`` as two processes runs ``learn``,
``selfplay`` and ``learn`` again on one directory (only rank 0 writes,
both ranks log their step lines, as ``tests/test_multihost_drivers.py``);
``broadcast_lines`` makes two collectives for each read window
(``tests/test_multihost_broadcast_guard.py``'s bound); and
``tools.multihost_scaling`` writes JAX's JSON keys and leaves the
learner's last, finishing flush out of its rate.
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from takzero_torch.drivers import coscheduled, evaluation, learn, puzzle, reanalyze, selfplay
from takzero_torch.models.agent import new_agent
from takzero_torch.ops.bitset import bitset_init, bitset_set
from takzero_torch.parallel import multihost
from takzero_torch.tools import multihost_scaling
from takzero_torch.utils import ckpt

import torch_ranks

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--net", "tiny3", "--device", "cpu"]
SELFPLAY = ["--batch", "8", "--budget", "16", "--sampled", "4"]


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A run directory with a pre-trained learner (model_0000000 and
    model_0000002) and 25 moves of selfplay targets and replays."""
    d = tmp_path_factory.mktemp("seeded")
    learn.main(["--directory", str(d), *TINY, "--seed", "1", "--batch-size", "8", "--pretrain-targets", "32",
                "--pretrain-steps", "2", "--max-steps", "0", "--no-wait"])
    selfplay.main(["--directory", str(d), *TINY, "--seed", "2", *SELFPLAY, "--max-steps", "25"])
    return d


def _worlds(tmp_path, base, run):
    """``run(directory, extra)`` in a copy of ``base`` (or an empty
    directory) with no ``--devices`` and with ``--devices 2``."""
    out = {}
    for name, extra in (("w1", []), ("w2", ["--devices", "2"])):
        d = tmp_path / name
        if base is None:
            d.mkdir()
        else:
            shutil.copytree(base, d)
        out[name] = (d, run(d, extra))
    return out


def _same_files(runs, names):
    (d1, _), (d2, _) = runs["w1"], runs["w2"]
    for name in names:
        assert (d1 / name).read_bytes() == (d2 / name).read_bytes(), name


def test_selfplay_on_two_ranks_writes_world_one_bytes(tmp_path):
    runs = _worlds(tmp_path, None, lambda d, extra: selfplay.main(
        ["--directory", str(d), *TINY, "--seed", "7", *SELFPLAY, "--max-steps", "25",
         "--dump-search", str(d / "search.txt"), *extra]))
    _same_files(runs, ["replays.txt", "targets-selfplay.txt", "search.txt"])
    (d, res), (_, res2) = runs["w1"], runs["w2"]
    assert res["replays"] == res2["replays"] == len((d / "replays.txt").read_text().splitlines()) > 0
    assert res2["targets"] == len((d / "targets-selfplay.txt").read_text().splitlines())


def test_learn_on_two_ranks_matches_world_one(tmp_path, seeded):
    runs = _worlds(tmp_path, seeded, lambda d, extra: learn.main(
        ["--directory", str(d), *TINY, "--seed", "3", "--batch-size", "8", "--pretrain-steps", "0",
         "--max-steps", "3", "--no-wait", "--steps-per-checkpoint", "5", *extra]))
    metrics = {}
    for name, (d, res) in runs.items():
        assert res["steps"] == 3
        rows = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in rows] == [3, 4, 5]  # each step's line once
        metrics[name] = rows
        # The seen-set of the step-5 checkpoint is the one the hash log rebuilds.
        idx, _ = ckpt.read_hash_indices(d / ckpt.HASH_LOG, 0)
        assert len(np.unique(idx)) == len(idx) > 0
        bits = bitset_set(bitset_init(12), torch.from_numpy(idx.astype(np.int64)))
        assert torch.equal(bits, ckpt.read_checkpoint(d / "model_0000005.ckpt")["hash_bits"])
    for i, (a, b) in enumerate(zip(metrics["w1"], metrics["w2"])):
        rtol = 1e-3 if i == 0 else 0.2
        for k in ("loss", "loss_policy", "loss_value", "loss_ube"):
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=f"step {a['step']} {k}")
    _same_files(runs, [ckpt.HASH_LOG, "targets-initial.txt", "buffer_lengths.txt"])


def test_reanalyze_on_two_ranks_writes_world_one_bytes(tmp_path, seeded):
    runs = _worlds(tmp_path, seeded, lambda d, extra: reanalyze.main(
        ["--directory", str(d), *TINY, "--seed", "4", "--batch", "4", "--budget", "16", "--sampled", "4",
         "--min-positions", "4", "--max-steps", "2", *extra]))
    _same_files(runs, ["targets-reanalyze.txt"])
    assert runs["w2"][1]["targets"] == 8


def test_evaluation_on_two_ranks_matches_world_one(tmp_path, seeded):
    runs = _worlds(tmp_path, None, lambda d, extra: evaluation.main(
        ["--model-path", str(seeded), *TINY, "--rounds", "1", "--games", "4", "--budget", "8", "--sampled", "4",
         "--seed", "11", "--max-moves", "20", "--rss-limit-gb", "0", *extra]))
    one, two = runs["w1"][1], runs["w2"][1]
    assert [(a, b, (r.wins, r.losses, r.draws, r.half_moves)) for a, b, r in one] == \
        [(a, b, (r.wins, r.losses, r.draws, r.half_moves)) for a, b, r in two]
    assert len(one) == 2 and sum(r.wins + r.losses + r.draws for _, _, r in one) > 0


def test_puzzle_on_two_ranks_matches_world_one(tmp_path):
    import dataclasses

    from takzero_torch.config import NET_PRESETS

    cfg = dataclasses.replace(NET_PRESETS["net6_simhash"], filters=16, blocks=2, hash_bits=12)
    model = ckpt.save_checkpoint(tmp_path, "model.ckpt", new_agent(cfg, seed=0, device="cpu"))
    argv = ["--model", str(model), "--puzzle-db", str(REPO / "examples" / "puzzles_6x6_sample.db"),
            "--net", "net6_simhash", "--filters", "16", "--blocks", "2", "--hash-bits", "12",
            "--search-budget", "16", "--sampled-actions", "4", "--depths", "3", "--avoidance-depths", "2",
            "--device", "cpu"]
    one, two = puzzle.main(argv), puzzle.main(argv + ["--devices", "2"])
    assert one == two and sum(r.attempted for r in one) > 0


def _target_fields(line: str):
    """(TPS, value, UBE, policy actions, policy probabilities) of a target line."""
    tps, value, ube, policy = line.split(";")
    pairs = [p.rsplit(":", 1) for p in policy.split(",")]
    return tps, value, ube, [a for a, _ in pairs], np.array([float(p) for _, p in pairs])


def test_coscheduled_on_two_ranks_writes_world_one_files(tmp_path):
    runs = _worlds(tmp_path, None, lambda d, extra: coscheduled.main(
        ["--directory", str(d), *TINY, "--seed", "5", *SELFPLAY, "--batch-size", "8", "--max-moves", "12",
         "--pretrain-steps", "2", "--pretrain-targets", "16", *extra]))
    res1, res2 = runs["w1"][1], runs["w2"][1]
    assert res1["train_steps"] == res2["train_steps"] > 0 and res1["replays"] == res2["replays"] > 0
    _same_files(runs, ["replays.txt", "targets-initial.txt", "buffer_lengths.txt", ckpt.HASH_LOG])
    assert torch.equal(res1["agent"]["hash_bits"], res2["agent"]["hash_bits"])
    # From the first train step on the bf16 weights differ in their last
    # bits (the global BatchNorm sums and the summed gradients round apart,
    # as in the learner's test), so a search's visits, and so its improved
    # policy, move a little (held to 5e-2, the bf16 tolerance of
    # tests/test_torch_learner.py), and a UBE target (the variance of the
    # child that wins an argmax) may take another child of a near tie; the
    # games, the positions, the actions and the values do not differ.
    (d1, _), (d2, _) = runs["w1"], runs["w2"]
    lines1, lines2 = ((d / "targets-selfplay.txt").read_text().splitlines() for d in (d1, d2))
    assert len(lines1) == len(lines2) > 0
    for a, b in zip(lines1, lines2):
        (tps, value, _, acts, probs), (tps2, value2, _, acts2, probs2) = _target_fields(a), _target_fields(b)
        assert (tps, value, acts) == (tps2, value2, acts2)
        np.testing.assert_allclose(probs2, probs, rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# The launcher, the broadcast guard and the scaling tool.
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("WORLD_SIZE", None)
    return env


def _launch(tmp_path, tag: str, driver: str, args: list) -> list:
    """``drivers.multihost`` as two processes over a ``file://`` rendezvous;
    returns each process's output."""
    url = f"file://{tmp_path / f'rendezvous_{tag}'}"
    procs = [
        subprocess.Popen([sys.executable, "-m", "takzero_torch.drivers.multihost", "--coordinator", url,
                          "--num-processes", "2", "--process-id", str(pid), driver, "--", *args],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(), text=True, cwd=tmp_path)
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:  # never leak the pair
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_launcher_runs_learn_then_selfplay(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    outs = _launch(tmp_path, "learn", "learn", ["--directory", str(d), *TINY, "--seed", "1", "--batch-size", "8",
                                                "--pretrain-targets", "32", "--pretrain-steps", "2",
                                                "--max-steps", "0", "--no-wait"])
    assert "multihost: rank 0/2" in outs[0] and "multihost: rank 1/2" in outs[1]
    assert (d / "model_latest.ckpt").exists() and (d / "model_0000002.ckpt").exists()
    # Written once: a second writer would double the 32 lines.
    assert len((d / "targets-initial.txt").read_text().splitlines()) == 32

    outs = _launch(tmp_path, "selfplay", "selfplay", ["--directory", str(d), *TINY, "--seed", "3", *SELFPLAY,
                                                      "--max-steps", "20"])
    logged = sum(int(m.group(1)) for m in re.finditer(r"; (\d+) targets, \d+ replays", outs[0]))
    assert len((d / "targets-selfplay.txt").read_text().splitlines()) == logged > 0
    assert all("step 20:" in o for o in outs)

    outs = _launch(tmp_path, "learn2", "learn", ["--directory", str(d), *TINY, "--seed", "5", "--batch-size", "8",
                                                 "--pretrain-steps", "0", "--max-steps", "2", "--no-wait"])
    assert all("resuming from" in o and "step 3: loss=" in o for o in outs)
    assert [json.loads(x)["step"] for x in (d / "metrics.jsonl").read_text().splitlines()] == [3, 4]


def test_broadcast_lines_two_collectives_per_read_window(tmp_path, seeded):
    d = tmp_path / "run"
    shutil.copytree(seeded, d)
    n_targets = len((d / "targets-selfplay.txt").read_text().splitlines())
    steps = 6
    calls = multihost.run_ranks(torch_ranks.learn_counting_broadcasts,
                                ["--directory", str(d), *TINY, "--seed", "1", "--batch-size", "8",
                                 "--pretrain-steps", "0", "--no-wait", "--max-steps", str(steps),
                                 "--chunk-steps", "2"], 2, "gloo", threads=1)
    assert calls[0] == calls[1]
    c = calls[0]
    # Every target line came through the broadcasts, and the count of
    # collectives follows the read windows (a read-gate flag each, a
    # length and a payload per file read), never the lines.
    assert sum(c["payloads"]) == n_targets and max(c["payloads"]) == n_targets
    assert c["lines"] <= 2 * c["scalar"] + 2
    assert c["scalar"] <= steps + 8, c


def test_multihost_scaling_writes_jax_keys(tmp_path):
    out = tmp_path / "scaling.json"
    env = _env()
    res = subprocess.run([sys.executable, "-m", "takzero_torch.tools.multihost_scaling", "--configs", "1x1,2x1",
                          "--steps", "8", "--chunk-steps", "2", "--repeats", "1", "--targets", "64",
                          "--global-batch", "8", "--device", "cpu", "--out", str(out)],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rows = json.loads(out.read_text())
    jax_keys = {"processes", "devices_per_process", "global_devices", "chunks", "steps_per_s", "steps_per_s_all",
                "steps_per_s_reps"}
    assert [(r["processes"], r["devices_per_process"], r["global_devices"]) for r in rows] == [(1, 1, 1), (2, 1, 2)]
    assert all(jax_keys <= set(r) and r["steps_per_s"] > 0 for r in rows)
    assert "vs_first" in rows[1] and "vs_first" not in rows[0]
    assert multihost_scaling._CHUNK_RE.pattern == r"chunk of (\d+) flushed: ([\d.]+) steps/s"


def test_multihost_scaling_skips_the_warm_up_and_the_final_flush():
    # The learner flushes its last chunk as it finishes, moments after the
    # one before it: that line's rate is not a steady-state rate.
    log = "\n".join(f"INFO:learn:chunk of {n} flushed: {r} steps/s end-to-end"
                    for n, r in ((4, 9.0), (4, 70.0), (2, 40.0), (4, 72.0), (4, 68.0), (4, 2197.1)))
    chunks, rate = multihost_scaling.steady_rate(log, 4)
    assert len(chunks) == 6 and rate == 70.0
    with pytest.raises(RuntimeError, match="wanted >= 3 chunk lines"):
        multihost_scaling.steady_rate(log.split("\n", 4)[-1], 4)
