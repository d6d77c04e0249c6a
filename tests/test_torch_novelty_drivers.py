"""The port's drivers with every novelty variant, on the CPU.

* ``drivers/learn.py`` at ``tiny3_rnd`` refreshes the RND bounds once
  before its loop and again after the chunk that ends on step 100, each
  time from the two reference batches (ply 8 and ply 60, 64 positions),
  and trains the predictor; ``model_latest.ckpt`` carries the RND weights
  and bounds.
* At ``tiny4`` (LCG hash over 2^24 bits) the learner writes a hash log
  that a reader replays to the learner's seen-set, and only fresh indices.
* Every driver (learn, selfplay, reanalyze, coscheduled, evaluation,
  puzzle, TEI, analysis) runs a net of each variant: tiny3-sized rnd, MLP
  rnd, lcghash and ensemble presets, added to ``NET_PRESETS`` for the
  test.  The ensemble learner warns that it leaves the heads untrained.
* ``tiny_run`` with ``--novelty rnd --beta 0.25`` and each other variant
  runs at a tiny cut.
"""

import dataclasses
import io
import logging
import sqlite3

import numpy as np
import pytest
import torch

from takzero_tpu.utils import ckpt as jax_ckpt
from takzero_torch import tiny_run
from takzero_torch.config import NET_PRESETS
from takzero_torch.drivers import analysis, coscheduled, evaluation, learn, puzzle, reanalyze, selfplay
from takzero_torch.drivers.tei import TeiEngine
from takzero_torch.eee.harness import random_plane_batch
from takzero_torch.models.agent import new_agent, rnd_update_normalization
from takzero_torch.ops.bitset import bitset_init, bitset_set
from takzero_torch.parallel import coordinator as co
from takzero_torch.tak import engine as torch_engine
from takzero_torch.train.data import random_pretraining_targets
from takzero_torch.utils import ckpt

torch.set_num_threads(2)

SMALL = {
    "t3_rnd": NET_PRESETS["tiny3_rnd"],
    "t3_mlp": dataclasses.replace(NET_PRESETS["tiny3_rnd"], rnd_mlp=True),
    "t3_lcg": dataclasses.replace(NET_PRESETS["tiny3"], novelty="lcghash", hash_bits=16),
    "t3_ens": dataclasses.replace(NET_PRESETS["tiny3"], novelty="ensemble", ensemble_size=4),
}


def _learn(d, net, *extra):
    return learn.main(["--directory", str(d), "--net", net, "--batch-size", "8", "--no-wait",
                       "--device", "cpu", *extra])


def _selfplay_targets(d, n: int, count: int, seed: int) -> None:
    eng = torch_engine(n, half_komi=NET_PRESETS["tiny4"].half_komi if n == 4 else 0)
    lines = [t.to_line() for t in random_pretraining_targets(eng, count, np.random.default_rng(seed),
                                                              device="cpu")]
    (d / co.TARGETS_SELFPLAY).write_text("\n".join(lines) + "\n")


def _log_bits(d, bits: int) -> torch.Tensor:
    idx, _ = jax_ckpt.read_hash_indices(d / ckpt.HASH_LOG, 0)
    return bitset_set(bitset_init(bits), torch.from_numpy(idx.astype(np.int64)))


def test_learn_driver_refreshes_rnd_bounds_at_start_and_step_100(tmp_path):
    d = tmp_path
    cfg = NET_PRESETS["tiny3_rnd"]
    first = _learn(d, "tiny3_rnd", "--seed", "1", "--pretrain-targets", "32", "--pretrain-steps", "2",
                   "--max-steps", "0")
    assert [s for s, _, _ in first["rnd_refreshes"]] == [2]
    assert not (d / ckpt.HASH_LOG).exists()
    latest = ckpt.read_checkpoint(d / "model_latest.ckpt")
    assert {"net", "rnd", "rnd_min", "rnd_max"} <= set(latest) and "hash_bits" not in latest
    _, lo, hi = first["rnd_refreshes"][0]
    assert float(latest["rnd_min"]) == lo < hi == float(latest["rnd_max"])

    _selfplay_targets(d, 3, 300, seed=2)
    out = _learn(d, "tiny3_rnd", "--seed", "3", "--pretrain-steps", "0", "--max-steps", "98",
                 "--chunk-steps", "10")
    assert out["steps"] == 98
    assert [s for s, _, _ in out["rnd_refreshes"]] == [2, 100]
    # The bounds at step 100 are those of the refs from the step-100 weights.
    agent = ckpt.load_checkpoint(d / "model_latest.ckpt", new_agent(cfg, seed=7, device="cpu"))
    eng = torch_engine(3)
    refs = [random_plane_batch(eng, torch.Generator().manual_seed(3 ^ salt), ply, 64)
            for salt, ply in ((0xE, 8), (0xF, 60))]
    got = float(agent["rnd_min"]), float(agent["rnd_max"])
    assert got == out["rnd_refreshes"][-1][1:]
    rnd_update_normalization(cfg, agent, *refs)
    assert (float(agent["rnd_min"]), float(agent["rnd_max"])) == got
    m = [line for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert len(m) == 98 and all('"loss_rnd"' in line for line in m)
    first_pre = ckpt.read_checkpoint(d / "model_0000000.ckpt")["rnd"]
    assert not torch.equal(agent["rnd"].state_dict()["predictor.stem.conv.weight"],
                           first_pre["predictor.stem.conv.weight"])
    for k, v in first_pre.items():
        if k.startswith("target."):
            assert torch.equal(agent["rnd"].state_dict()[k], v), k


def test_learn_driver_lcghash_log_replays_to_the_seen_set(tmp_path):
    d = tmp_path
    _learn(d, "tiny4", "--seed", "1", "--pretrain-targets", "32", "--pretrain-steps", "2", "--max-steps", "0")
    pre = ckpt.read_checkpoint(d / "model_0000002.ckpt")
    assert "hash_scale" in pre and "hash_matrix" not in pre
    assert torch.equal(_log_bits(d, 24), pre["hash_bits"])
    _selfplay_targets(d, 4, 48, seed=5)
    _learn(d, "tiny4", "--seed", "3", "--pretrain-steps", "0", "--max-steps", "4", "--chunk-steps", "2",
           "--steps-per-checkpoint", "6")
    step6 = ckpt.read_checkpoint(d / "model_0000006.ckpt")
    assert torch.equal(_log_bits(d, 24), step6["hash_bits"])
    idx, _ = jax_ckpt.read_hash_indices(d / ckpt.HASH_LOG, 0)
    assert len(np.unique(idx)) == len(idx)  # only fresh bits reach the log
    assert "hash_bits" not in ckpt.read_checkpoint(d / "model_latest.ckpt")


def _puzzle_db(path) -> None:
    """One 3x3 win-in-1 in the reference schema (tests/test_torch_evaluation.py)."""
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE games (id INTEGER PRIMARY KEY, size INTEGER)")
    con.execute("""CREATE TABLE puzzles (game_id INTEGER, tps TEXT, solution TEXT, tinue_length INTEGER,
        tinue_avoidance_length INTEGER, tiltak_2komi_second_move_eval REAL, tiltak_2komi_eval REAL)""")
    con.execute("INSERT INTO games VALUES (1, 3)")
    con.execute("INSERT INTO puzzles VALUES (1, '2,x,1/x,1,2/x,1,2 1 4', 'b3', 1, NULL, 0.0, 0.0)")
    con.commit()
    con.close()


@pytest.mark.parametrize("net", list(SMALL))
def test_every_driver_runs_each_variant(net, tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(NET_PRESETS, net, SMALL[net])
    cfg = SMALL[net]
    d = tmp_path
    common = ["--directory", str(d), "--net", net, "--device", "cpu"]
    search = ["--batch", "4", "--budget", "16", "--sampled", "4"]
    with caplog.at_level(logging.WARNING, logger="learn"):
        _learn(d, net, "--seed", "1", "--pretrain-targets", "32", "--pretrain-steps", "2", "--max-steps", "0")
    warned = any("NOT trained" in r.getMessage() for r in caplog.records)
    assert warned == (cfg.novelty == "ensemble")
    sp = selfplay.main(common + search + ["--seed", "2", "--max-steps", "16"])
    assert sp["reloads"] == 1 and sp["replays"] >= 1
    learner = ckpt.load_checkpoint(d / "model_latest.ckpt", new_agent(cfg, seed=9, device="cpu"))
    for key, v in ckpt._bundle_tensors(learner).items():
        if key != "hash_bits":
            assert torch.equal(v, ckpt._bundle_tensors(sp["agent"])[key]), key
    if cfg.novelty == "lcghash":
        assert torch.equal(sp["agent"]["hash_bits"], _log_bits(d, cfg.hash_bits))
    re = reanalyze.main(common + search + ["--seed", "4", "--min-positions", "4", "--max-steps", "1"])
    assert re["steps"] == 1 and re["targets"] == 4
    cs = coscheduled.main(["--directory", str(d / "cs"), "--net", net, "--device", "cpu", *search,
                           "--batch-size", "8", "--max-moves", "16", "--seed", "5", "--pretrain-steps", "2",
                           "--pretrain-targets", "16"])
    assert cs["moves"] == 16 and cs["train_steps"] > 0 and cs["nonfinite_steps"] == 0
    assert ("hash_bits" in cs["agent"]) == (cfg.novelty == "lcghash")

    names = ["model_0000000.ckpt", "model_0000002.ckpt"]
    res = evaluation.main(["--model-path", str(d), "--net", net, "--pair", ",".join(names), "--games", "2",
                           "--sampled", "4", "--budget", "8", "--max-moves", "6", "--seed", "3",
                           "--rss-limit-gb", "0", "--device", "cpu"])
    assert len(res) == 2 and all(r.wins + r.losses + r.draws <= 2 for *_, r in res)
    _puzzle_db(d / "p.db")
    pz = puzzle.main(["--model", str(d / "model_0000002.ckpt"), "--puzzle-db", str(d / "p.db"), "--net", net,
                      "--depths", "1", "--avoidance-depths", "", "--sampled-actions", "16",
                      "--search-budget", "64", "--device", "cpu"])
    assert [(r.category, r.attempted) for r in pz] == [("tinue", 1)]
    out = io.StringIO()
    tei = TeiEngine(net, str(d / "model_latest.ckpt"), out=out, device="cpu")
    for cmd in ("tei", "isready", "position startpos", "go nodes 64"):
        tei.handle(cmd)
    assert "bestmove" in out.getvalue()
    monkeypatch.setattr("sys.stdin", io.StringIO("go\nquit\n"))
    analysis.main(["--net", net, "--model", str(d / "model_latest.ckpt"), "--device", "cpu"])


@pytest.mark.parametrize("argv", [["--novelty", "rnd", "--beta", "0.25"], ["--novelty", "rnd", "--rnd-mlp"],
                                  ["--novelty", "lcghash"], ["--novelty", "ensemble"]],
                         ids=["rnd", "rnd_mlp", "lcghash", "ensemble"])
def test_tiny_run_takes_every_novelty(argv, tmp_path):
    res = tiny_run.main(argv + ["--iters", "2", "--moves-per-iter", "6", "--steps-per-iter", "2", "--batch", "8",
                                "--pretrain-steps", "2", "--eval-games", "2", "--budget", "16", "--sampled", "4",
                                "--out", str(tmp_path / "t.json"), "--device", "cpu"])
    assert res["games"] == 4 and np.isfinite(res["final_loss"])
    trained, initial = res["agent"], res["initial_agent"]
    if "rnd" in trained:
        # Refreshed at iteration 0 (the first that trains); the initial
        # bundle keeps its own bounds and weights.
        assert (float(trained["rnd_min"]), float(trained["rnd_max"])) != (0.0, 1.0)
        assert (float(initial["rnd_min"]), float(initial["rnd_max"])) == (0.0, 1.0)
        assert float(trained["rnd_min"]) < float(trained["rnd_max"])
        for k, v in initial["rnd"].state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, trained["rnd"].state_dict()[k]) == k.startswith("target."), k
    if "ensemble" in trained:
        for k, v in initial["ensemble"].state_dict().items():
            assert torch.equal(v, trained["ensemble"].state_dict()[k]), k
