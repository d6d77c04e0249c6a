"""One-process training: the port's co-scheduled driver, flush helpers, Elo
fit and ``tiny_run`` against the JAX package's.

* ``utils/flush.py`` on ``tests/test_flush.py``'s cases: the packed words
  equal JAX's bit for bit, and the unpacked metrics and fresh indices
  exactly.
* ``tools/elo.py``'s ``fit_elo`` and ``elo_curves`` against JAX's on random
  match tables, to 1e-9.
* ``drivers/coscheduled.py`` against ``takzero_tpu/drivers/coscheduled.py``
  at tiny3 in float32 on both sides, from JAX's initial weights (bridged,
  written as the port's ``model_0000000.ckpt``) and with JAX's draws (the
  driver's ``jax.random.split`` chain, replayed through ``torch_parity``),
  with ``--reanalyze`` on, for the 8 moves that hold the first optimizer
  steps, reanalyze's first batches and the first mixed 64+64 steps:
  the per-move schedule that both drivers log must be equal; replays and
  buffer lengths byte for byte; target lines field by field (TPS, actions
  and selfplay values exactly; probabilities, UBE and reanalyze values to
  1e-4, the network's tolerance in ``tests/test_torch_selfplay.py``); the
  train metrics of those steps to 1e-5 (``tests/test_torch_learner.py``);
  ``hash_log.bin`` byte for byte.  Then the port alone, with pre-training,
  checks ``tests/test_coscheduled.py``'s artifacts.
* A train step drops the folded weights, and the next evaluation refolds.
* ``tiny_run`` at a tiny cut: the summary's keys, and trained weights that
  differ from the deep-copied initial ones.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu import config as jax_config
from takzero_tpu.data.native_loader import valid_target_lines
from takzero_tpu.drivers import coscheduled as jax_coscheduled
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.tools import elo as jax_elo
from takzero_tpu.utils import ckpt as jax_ckpt
from takzero_tpu.utils import flush as jax_flush
from takzero_torch import config as torch_config
from takzero_torch import tiny_run
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.data.native_loader import make_batch_native
from takzero_torch.data.target import Target
from takzero_torch.drivers import coscheduled
from takzero_torch.models.agent import make_net_evaluate, new_agent
from takzero_torch.ops.bitset import bitset_init, bitset_set
from takzero_torch.parallel import coordinator as co
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tools import elo
from takzero_torch.train.data import random_pretraining_targets
from takzero_torch.train.learner import make_optimizer, make_train_step
from takzero_torch.utils import ckpt, flush

from torch_parity import move_draws, opening_draws, search_draws

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


# ---------------------------------------------------------------------------
# Flush helpers and the Elo fit.
# ---------------------------------------------------------------------------


def _metrics(rng, c):
    return {k: rng.normal(size=c).astype(np.float32) for k in ("loss", "loss_policy", "loss_value", "loss_ube")}


@pytest.mark.parametrize("with_idx", [True, False])
def test_pack_unpack_flush_match_jax(with_idx):
    rng = np.random.default_rng(0)
    c, n = 7, 96
    m = _metrics(rng, c)
    idx = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    fresh = rng.integers(0, 2, size=n).astype(bool)
    args = (idx, fresh) if with_idx else ()
    want = np.asarray(jax_flush.pack_flush({k: jnp.asarray(v) for k, v in m.items()},
                                           *(jnp.asarray(a) for a in args)))
    got = flush.pack_flush({k: torch.from_numpy(v) for k, v in m.items()},
                           *(torch.from_numpy(a.astype(np.int64)) for a in args))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(np.uint32), want)
    gm, gi = flush.unpack_flush(got, list(m)[::-1], c, with_idx)
    wm, wi = jax_flush.unpack_flush(want, list(m), c, with_idx)
    for k in m:
        np.testing.assert_array_equal(gm[k], wm[k])
        np.testing.assert_array_equal(gm[k], m[k])
    if with_idx:
        assert gi.dtype == np.dtype("<u4")
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gi, jax_ckpt.fresh_indices(idx, fresh))
    else:
        assert gi is None and wi is None


def test_drain_index_pairs_matches_jax():
    rng = np.random.default_rng(1)
    pairs = [(rng.integers(0, 1000, size=32).astype(np.uint32), rng.integers(0, 2, size=32).astype(bool))
             for _ in range(9)]
    want = jax_flush.drain_index_pairs([(jnp.asarray(i), jnp.asarray(f)) for i, f in pairs], group=4)
    tpairs = [(torch.from_numpy(i.astype(np.int64)), torch.from_numpy(f)) for i, f in pairs]
    for group in (4, 64):  # several groups, and one
        got = flush.drain_index_pairs(tpairs, group=group)
        assert got.dtype == np.dtype("<u4")
        np.testing.assert_array_equal(got, want)
    assert flush.drain_index_pairs([]).shape == (0,)


def test_fit_elo_matches_jax_on_random_tables(tmp_path):
    rng = np.random.default_rng(2)
    for trial in range(6):
        players = int(rng.integers(2, 7))
        rows = []
        for _ in range(int(rng.integers(1, 12))):
            w, b = rng.choice(players, size=2, replace=False)
            rows.append(("run" if trial % 2 else f"m{w % 2}", int(w) * 100, "run" if trial % 2 else f"m{b % 2}",
                         int(b) * 100, *(int(x) for x in rng.integers(0, 30, size=3))))
        path = tmp_path / f"results{trial}.csv"
        path.write_text("".join(", ".join(map(str, r)) + "\n" for r in rows))
        got, want = elo.read_results(path), jax_elo.read_results(path)
        assert [dataclasses.astuple(m) for m in got] == [dataclasses.astuple(m) for m in want]
        gr, wr = elo.fit_elo(got), jax_elo.fit_elo(want)
        assert gr.keys() == wr.keys()
        for k in wr:
            np.testing.assert_allclose(gr[k], wr[k], rtol=1e-9, atol=1e-9, err_msg=k)
        gc, wc = elo.elo_curves(got), jax_elo.elo_curves(want)
        assert gc.keys() == wc.keys()
        for k in wc:
            np.testing.assert_allclose(np.array(gc[k]), np.array(wc[k]), rtol=1e-9, atol=1e-9, err_msg=k)
    assert elo.name("run", 300) == jax_elo.name("run", 300) == "run_300"


# ---------------------------------------------------------------------------
# The co-scheduled driver.
# ---------------------------------------------------------------------------

BASE = ["--net", "tiny3", "--seed", "3", "--batch", "4", "--budget", "16", "--sampled", "4",
        "--batch-size", "8", "--steps-per-move", "2"]
REANALYZE = ["--reanalyze", "--reanalyze-min-positions", "16", "--reanalyze-batch", "8",
             "--steps-before-reanalyze", "4"]
# At BASE + REANALYZE with JAX's draws of seed 3 (the test checks these):
# the first optimizer steps follow move 5, reanalyze joins at move 7 and
# the steps after it are mixed; the comparison runs through move 8.
FIRST_STEP_MOVE, MOVES = 5, 8


class JaxChain:
    """JAX's driver's draws: ``key`` split once for the openings, once per
    move and once per reanalyze batch, in the loop's order."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def opening(self, batch, children):
        return opening_draws(self._next(), batch)

    def move(self, batch, children):
        return move_draws(self._next(), batch, children)

    def search(self, batch, children):
        return search_draws(self._next(), batch, children)


def _schedule(caplog) -> list:
    """(move, train steps, buffer, re_buffer, targets, re-targets, replays,
    model step) of every per-move log line; the two times are left out."""
    out = [r.args for r in caplog.records if r.name == "coscheduled" and r.msg.startswith("move ")]
    return [(a[0], a[2], *a[4:]) for a in out]


def _assert_target_files(tdir, jdir, name, value_tol):
    tl = (tdir / name).read_text().splitlines()
    jl = (jdir / name).read_text().splitlines()
    assert len(tl) == len(jl) > 0, name
    for a, b in zip((Target.from_line(3, x) for x in tl), (Target.from_line(3, x) for x in jl)):
        assert a.tps == b.tps and [x for x, _ in a.policy] == [x for x, _ in b.policy], (name, a.tps)
        np.testing.assert_allclose([p for _, p in a.policy], [p for _, p in b.policy], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.ube, b.ube, rtol=1e-4, atol=1e-4)
        if value_tol is None:
            assert a.value == b.value, (name, a.tps)
        else:
            np.testing.assert_allclose(a.value, b.value, rtol=value_tol, atol=value_tol)


def test_coscheduled_matches_jax_through_the_first_steps(tmp_path, monkeypatch, caplog):
    jcfg = dataclasses.replace(jax_config.NET_PRESETS["tiny3"], compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_config.NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    monkeypatch.setitem(jax_config.NET_PRESETS, "tiny3", jcfg)
    monkeypatch.setitem(torch_config.NET_PRESETS, "tiny3", tcfg)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    tdir.mkdir()
    ckpt.save_checkpoint(tdir, "model_0000000.ckpt",
                         from_jax_bundle(jax.tree.map(np.asarray, jax_new_agent(jcfg, seed=3)), tcfg, "cpu"))

    # Each driver's train-step metrics, as floats (JAX's from inside its jit).
    jmetrics, tmetrics = [], []
    jax_make, torch_make = jax_coscheduled.make_train_step, coscheduled.make_train_step

    def jax_recording(cfg, tx):
        inner = jax_make(cfg, tx)

        def step(bundle, opt_state, batch, train_ube):
            out = inner(bundle, opt_state, batch, train_ube=train_ube)
            jax.debug.callback(lambda m: jmetrics.append({k: float(v) for k, v in m.items()}), out[2])
            return out

        return step

    def torch_recording(cfg, *world):
        inner = torch_make(cfg, *world)

        def step(*a, **kw):
            m = inner(*a, **kw)
            tmetrics.append({k: float(v) for k, v in m.items()})
            return m

        return step

    monkeypatch.setattr(jax_coscheduled, "make_train_step", jax_recording)
    monkeypatch.setattr(coscheduled, "make_train_step", torch_recording)
    argv = [*BASE, *REANALYZE, "--max-moves", str(MOVES)]
    with caplog.at_level(logging.INFO, logger="coscheduled"):
        jax_coscheduled.main(["--directory", str(jdir), *argv])
        jsched = _schedule(caplog)
        caplog.clear()
        out = coscheduled.main(["--directory", str(tdir), *argv, "--device", "cpu"], draws=JaxChain(3))
        tsched = _schedule(caplog)

    assert tsched == jsched and len(tsched) == MOVES
    assert [s[1] > 0 for s in tsched].index(True) + 1 == FIRST_STEP_MOVE
    assert out["reanalyze_batches"] == 2 and out["mixed_steps"] == 4 and out["train_steps"] == tsched[-1][-1] == 7
    for name in (co.REPLAYS, co.BUFFER_LENGTHS):
        assert (tdir / name).read_text() == (jdir / name).read_text(), name
    assert not (tdir / co.REPLAYS_EXPLORATION).exists() and not (jdir / co.REPLAYS_EXPLORATION).exists()
    _assert_target_files(tdir, jdir, co.TARGETS_SELFPLAY, None)
    _assert_target_files(tdir, jdir, co.TARGETS_REANALYZE, 1e-4)
    assert len(tmetrics) == len(jmetrics) == 7
    for t, j in zip(tmetrics, jmetrics):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert (tdir / ckpt.HASH_LOG).read_bytes() == (jdir / ckpt.HASH_LOG).read_bytes()
    assert (tdir / ckpt.HASH_LOG).stat().st_size > 0


def test_coscheduled_artifacts_with_pretraining_and_reanalyze(tmp_path):
    """``tests/test_coscheduled.py``'s checks on the port alone, with its
    own draws: pre-training, reanalyze joining, mixed batches after the
    switch-on, fleet files, checkpoints and the hash log."""
    out = coscheduled.main(["--directory", str(tmp_path), *BASE, *REANALYZE, "--max-moves", "40",
                            "--pretrain-steps", "2", "--pretrain-targets", "32", "--device", "cpu"])
    cfg = torch_config.NET_PRESETS["tiny3"]
    for name in (co.TARGETS_SELFPLAY, co.REPLAYS, co.BUFFER_LENGTHS, co.TARGETS_INITIAL):
        assert (tmp_path / name).exists(), name
    steps, path = ckpt.model_path_with_most_steps(tmp_path)
    assert steps == out["model_steps"] == out["pretrain_steps"] + out["train_steps"] and steps > 4
    assert out["pretrain_steps"] == 2 and out["mixed_steps"] > 0 and out["nonfinite_steps"] == 0
    assert out["moves"] == 40 and out["reanalyze_batches"] > 0
    assert "hash_bits" not in ckpt.read_checkpoint(tmp_path / "model_latest.ckpt")
    init = ckpt.load_checkpoint(tmp_path / "model_0000000.ckpt", new_agent(cfg, seed=9, device="cpu"))
    trained = ckpt.load_checkpoint(path, new_agent(cfg, seed=9, device="cpu"))
    assert not torch.equal(trained["net"].policy.weight, init["net"].policy.weight)
    re_lines = (tmp_path / co.TARGETS_REANALYZE).read_text().splitlines()
    assert len(re_lines) == out["reanalyze_targets"] > 0
    assert len(valid_target_lines(3, re_lines)) == len(re_lines)
    assert len((tmp_path / co.TARGETS_SELFPLAY).read_text().splitlines()) == out["targets"]
    idx, _ = jax_ckpt.read_hash_indices(tmp_path / ckpt.HASH_LOG, 0)
    seen = bitset_set(bitset_init(cfg.hash_bits), torch.from_numpy(idx.astype(np.int64)))
    assert torch.equal(seen, trained["hash_bits"]) and torch.equal(seen, out["agent"]["hash_bits"])
    assert int(seen.ne(0).sum()) > 0


def test_coscheduled_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """--devices runs (ROADMAP queue 1, item 5): a game or train batch that
    N does not divide is a parser error, more cards than are visible
    raise, --devices 1 runs one rank in this process; WORLD_SIZE > 1
    without a process group is refused."""
    d = tmp_path / "refused"
    d.mkdir()
    base = ["--directory", str(d), "--net", "tiny3", "--max-moves", "1", "--batch", "4", "--batch-size", "6"]
    with pytest.raises(SystemExit):
        coscheduled.main(base + ["--device", "cpu", "--devices", "3"])  # --batch 4
    with pytest.raises(SystemExit):
        coscheduled.main(base + ["--device", "cpu", "--devices", "4"])  # --batch-size 6
    with pytest.raises(ValueError, match="--devices 2 but only 0 visible"):
        coscheduled.main(base + ["--device", "cuda", "--devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="multihost"):
        coscheduled.main(base + ["--device", "cpu"])
    assert not any(d.iterdir())
    monkeypatch.delenv("WORLD_SIZE")
    runs = tmp_path / "runs"
    out = coscheduled.main(["--directory", str(runs), "--net", "tiny3", "--max-moves", "1", "--batch", "4",
                            "--device", "cpu", "--devices", "1"])
    assert out["moves"] == 1 and (runs / "model_0000000.ckpt").exists()


def test_train_step_drops_the_fold_and_the_next_evaluation_refolds():
    cfg = torch_config.NET_PRESETS["tiny3"]
    eng = torch_engine(3)
    bundle = new_agent(cfg, seed=1, device="cpu")
    evaluate = make_net_evaluate(cfg, eng, device="cpu")
    rng = np.random.default_rng(0)
    lines = "".join(t.to_line() + "\n" for t in random_pretraining_targets(eng, 16, rng, device="cpu"))
    envs = eng.initial(4)
    before = [x.clone() for x in evaluate(bundle, envs)]
    fold = bundle["folded"]
    make_train_step(cfg)(bundle, make_optimizer(bundle, 1e-3), make_batch_native(eng, lines, rng, device="cpu"),
                         train_ube=True)
    assert "folded" not in bundle
    after = evaluate(bundle, envs)
    assert bundle["folded"] is not fold
    assert not torch.equal(after[0], before[0]) and not torch.equal(after[1], before[1])


def test_tiny_run_at_a_tiny_cut(tmp_path):
    out = tmp_path / "sub" / "tiny.json"
    res = tiny_run.main(["--iters", "2", "--moves-per-iter", "6", "--steps-per-iter", "2", "--batch", "8",
                         "--pretrain-steps", "2", "--eval-games", "4", "--budget", "16", "--sampled", "4",
                         "--out", str(out), "--save-ckpt", str(tmp_path / "final.ckpt"), "--device", "cpu"],
                        on_iteration=(ends := []).append)
    assert ends == [-1, 0, 1]
    summary = json.loads(out.read_text())
    assert set(summary) == {"wins", "losses", "draws", "games", "elo_gain", "final_loss", "wall_s", "card"}
    assert summary["games"] == 8 == summary["wins"] + summary["losses"] + summary["draws"]
    assert summary["card"] == "cpu" and np.isfinite(summary["final_loss"]) and np.isfinite(summary["elo_gain"])
    trained, initial = res["agent"], res["initial_agent"]
    assert not torch.equal(trained["net"].policy.weight, initial["net"].policy.weight)
    assert not torch.equal(trained["net"].core.stem.bn.running_mean, initial["net"].core.stem.bn.running_mean)
    assert int(trained["hash_bits"].ne(0).sum()) > 0 and int(initial["hash_bits"].ne(0).sum()) == 0
    assert (tmp_path / "final.ckpt").exists()
