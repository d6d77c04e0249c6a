"""The port's selfplay actor against the JAX package's, and its plumbing.

* ``SelfplayEngine.play_move`` against JAX's at ``tiny3`` (batch 4, k=4,
  budget 16, C=32, ``exploration=True``) for 20 moves with the dummy
  evaluator and 12 with the bridged float32 network, and with C=4 so that
  truncated roots are padded (the set-up of
  ``tests/test_truncation_targets.py``).  The port's draws are rebuilt from
  JAX's keys (``torch_parity.move_draws``).  Targets are compared field by
  field: TPS, policy actions and values exactly, probabilities and UBE to
  1e-6 (dummy evaluator) or 1e-4 (network), the tolerances of
  ``tests/test_torch_selfplay.py``; replay lines byte for byte; and one
  ``dump_root_line``.
* ``LatestPoller``, the checkpoint checks before a load, backpressure
  against JAX's ``buffer_lengths.txt`` writer, and ``StepTrace``.
* Both actor drivers on the CPU between two learner runs: their lines
  pass JAX's parsers, and the learner trains on them.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.config import selfplay_preset as jax_selfplay_preset
from takzero_tpu.data import native_loader as jax_nl
from takzero_tpu.data.target import Replay as JaxReplay
from takzero_tpu.models.agent import make_net_evaluate as jax_net_evaluate
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.parallel import coordinator as jax_co
from takzero_tpu.search.agents import dummy_evaluator as jax_dummy
from takzero_tpu.search.agents import simple_evaluator as jax_simple
from takzero_tpu.selfplay import SelfplayConfig as JaxSelfplayConfig
from takzero_tpu.selfplay import SelfplayEngine as JaxSelfplay
from takzero_tpu.selfplay import dump_root_line as jax_dump_root_line
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak.oracle import Oracle
from takzero_tpu.utils import ckpt as jax_ckpt
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS, selfplay_preset
from takzero_torch.data.native_loader import make_batch_native
from takzero_torch.data.target import Replay, Target, result_string
from takzero_torch.drivers import learn, reanalyze, selfplay
from takzero_torch.models.agent import make_net_evaluate, new_agent
from takzero_torch.ops.bitset import bitset_init, bitset_set
from takzero_torch.parallel import coordinator as co
from takzero_torch.search.agents import dummy_evaluator, simple_evaluator
from takzero_torch.selfplay import SelfplayConfig, SelfplayEngine, dump_root_line
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tak.tps import tps_to_state
from takzero_torch.train.learner import make_optimizer, make_train_step
from takzero_torch.utils import ckpt
from takzero_torch.utils.profile import StepTrace

from torch_parity import move_draws, opening_draws

torch.set_num_threads(2)

BATCH, BUDGET, K, C, MOVES = 4, 16, 4, 32, 20
SP_KW = dict(batch=BATCH, search_budget=BUDGET, sampled_actions=K, max_children=C, exploration=True)


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _assert_targets(tt: list, jt: list, tol: float, where: str) -> None:
    assert len(tt) == len(jt), where
    for a, b in zip(tt, jt):
        assert a.tps == b.tps, where
        assert [x for x, _ in a.policy] == [x for x, _ in b.policy], (where, a.tps)
        np.testing.assert_allclose([p for _, p in a.policy], [p for _, p in b.policy],
                                   rtol=tol, atol=tol, err_msg=f"{where}: policy of {a.tps}")
        assert a.value == b.value, (where, a.tps)
        np.testing.assert_allclose(a.ube, b.ube, rtol=tol, atol=tol, err_msg=f"{where}: ube of {a.tps}")


def _dummy(eng_fn):
    return lambda eng: (lambda bundle, envs: eng_fn(eng)(envs))  # noqa: E731


def _network():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny3"], compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    jbundle = jax_new_agent(jcfg, seed=3)
    tagent = from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")
    return (lambda eng: jax_net_evaluate(jcfg, eng), lambda eng: make_net_evaluate(tcfg, eng, device="cpu"),
            jbundle, tagent)


CASES = {
    # (JAX config, port config, evaluators and agents, tolerance, moves)
    "dummy": lambda: (jax_selfplay_preset("tiny3", **SP_KW), selfplay_preset("tiny3", **SP_KW),
                      (_dummy(jax_dummy), _dummy(dummy_evaluator), None, None), 1e-6, MOVES),
    "network": lambda: (jax_selfplay_preset("tiny3", **SP_KW), selfplay_preset("tiny3", **SP_KW),
                        _network(), 1e-4, 12),
    # C=4: roots with more legal actions are truncated and padded.
    "truncated": lambda: (
        JaxSelfplayConfig(batch=4, beta=0.0, weighted_random_plies=2, sampled_actions=4,
                          search_budget=16, max_children=4, max_depth=16),
        SelfplayConfig(batch=4, beta=0.0, weighted_random_plies=2, sampled_actions=4,
                       search_budget=16, max_children=4, max_depth=16),
        (_dummy(jax_simple), _dummy(simple_evaluator), {}, None), 1e-6, 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_play_move_matches_jax(case):
    jcfg, tcfg, (jfactory, tfactory, jbundle, tagent), tol, moves = CASES[case]()
    jeng, teng = jax_engine(3), torch_engine(3)
    jsp = JaxSelfplay(jeng, jcfg, jfactory(jeng))
    tsp = SelfplayEngine(teng, tcfg, tfactory(teng), device="cpu")
    jsp.reset(jax.random.PRNGKey(5))
    tsp.reset(opening_draws(jax.random.PRNGKey(5), jcfg.batch))
    assert [g.start_tps for g in tsp.logs] == [g.start_tps for g in jsp.logs]
    got = {"targets": [], "replays": [], "exploration": []}
    for move in range(moves):
        key = jax.random.PRNGKey(100 + move)
        jt, jr, je = jsp.play_move(jbundle, key)
        tt, tr, te = tsp.play_move(tagent, move_draws(key, jcfg.batch, jcfg.max_children))
        where = f"{case}, move {move}"
        _assert_targets(tt, jt, tol, where)
        assert [r.to_line() for r in tr] == [r.to_line() for r in jr], where
        assert [r.to_line() for r in te] == [r.to_line() for r in je], where
        for name, items in zip(got, (tt, tr, te)):
            got[name] += items
    assert tsp.truncation_totals == jsp.truncation_totals
    assert len(got["replays"]) >= 4, got  # games finished
    if case == "dummy":
        # Lanes 0-1 explore: their early positions give no targets.
        assert got["exploration"] and len(got["exploration"]) < len(got["replays"])
        root = {k: v.numpy() for k, v in tsp.last_root.items()}
        line = dump_root_line(3, root, lane=1)
        assert line == jax_dump_root_line(3, jax.tree.map(np.asarray, jsp.last_root), lane=1)
        assert line.count(",") == int((root["action"][1] >= 0).sum())
    if case == "truncated":
        assert tsp.truncation_totals[1] > 0
        orc = Oracle(3, 0)
        padded = 0
        for t in got["targets"]:
            legal = set(np.flatnonzero(orc.legal_mask(jax_nl.parse_tps(3, t.tps))).tolist())
            assert {a for a, _ in t.policy} == legal and len(t.policy) == len(legal), t.tps
            padded += len(legal) > 4
        assert padded > 0
    # Every replay replays to its recorded result on the port's engine.
    eng = torch_engine(3)
    for r in got["replays"]:
        back = Replay.from_line(3, r.to_line())
        states = back.states(eng)
        last = eng.step(states[-1].map(lambda x: x[None]), torch.tensor([back.actions[-1]]))
        assert result_string(eng, last.map(lambda x: x[0])) == back.result, r.to_line()


def _tiny3():
    return NET_PRESETS["tiny3"]


def test_latest_poller(tmp_path, caplog):
    cfg = _tiny3()
    learner = new_agent(cfg, seed=1, device="cpu")
    actor = new_agent(cfg, seed=2, device="cpu")
    log = logging.getLogger("poller-test")
    poller = ckpt.LatestPoller(tmp_path)
    assert poller.reload_if_changed(actor, log) == (actor, False) and poller.reloads == 0

    def publish(idx=()):
        ckpt.save_checkpoint(tmp_path, "model_latest.ckpt", ckpt.strip_hash_bits(learner))
        ckpt.append_hash_indices(tmp_path, np.asarray(idx, "<u4"))

    def log_bits():
        idx, _ = jax_ckpt.read_hash_indices(tmp_path / ckpt.HASH_LOG, 0)
        return bitset_set(bitset_init(cfg.hash_bits), torch.from_numpy(idx.astype(np.int64)))

    def same_weights(a, b):
        return all(torch.equal(x, y) for x, y in zip(a["net"].state_dict().values(),
                                                     b["net"].state_dict().values()))

    publish([5, 77])
    assert poller.reload_if_changed(actor, log)[1] and poller.reloads == 1
    assert same_weights(actor, learner) and torch.equal(actor["hash_matrix"], learner["hash_matrix"])
    assert torch.equal(actor["hash_bits"], log_bits())
    # Unchanged file: no reload, no change.
    assert not poller.reload_if_changed(actor, log)[1] and poller.reloads == 1
    # A hash-log delta alone: the seen-set grows, the weights stay.
    ckpt.append_hash_indices(tmp_path, np.asarray([77, 4000, 1234], "<u4"))
    assert poller.reload_if_changed(actor, log)[1] and poller.reloads == 1
    assert torch.equal(actor["hash_bits"], log_bits()) and int(actor["hash_bits"].ne(0).sum()) == 4
    # A new save: one reload; the weights-only file keeps the seen-set.
    with torch.no_grad():
        learner["net"].policy.bias.add_(1.0)
    path = ckpt.latest_path(tmp_path)
    publish()
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert not same_weights(actor, learner)
    assert poller.reload_if_changed(actor, log)[1] and poller.reloads == 2
    assert same_weights(actor, learner) and torch.equal(actor["hash_bits"], log_bits())
    # A truncated file keeps the old weights, logs why, and is tried again.
    good = path.read_bytes()
    before = {k: v.clone() for k, v in actor["net"].state_dict().items()}
    path.write_bytes(good[: len(good) // 2])
    with caplog.at_level(logging.WARNING, logger="poller-test"):
        assert not poller.reload_if_changed(actor, log)[1]
    assert "keeping the current weights" in caplog.text and poller.reloads == 2
    assert all(torch.equal(before[k], v) for k, v in actor["net"].state_dict().items())
    path.write_bytes(good)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 2_000_000))
    assert poller.reload_if_changed(actor, log)[1] and poller.reloads == 3
    # A JAX learner's flax file loads: its weights, as the bridge carries them.
    jcfg = jax_network.NetConfig(n=3, half_komi=0, filters=16, blocks=2, hash_bits=12)
    jbundle = jax.tree.map(np.asarray, jax_new_agent(jcfg, seed=4))
    jax_ckpt.save_checkpoint(tmp_path, "model_latest.ckpt", jax_ckpt.strip_hash_bits(jbundle))
    os.utime(tmp_path / "model_latest.ckpt", ns=(st.st_atime_ns, st.st_mtime_ns + 4_000_000))
    assert poller.reload_if_changed(actor, log)[1]
    assert same_weights(actor, from_jax_bundle(jbundle, cfg, device="cpu"))
    # A file of neither format raises.
    (tmp_path / "model_latest.ckpt").write_bytes(b"GARBAGE!")
    os.utime(tmp_path / "model_latest.ckpt", ns=(st.st_atime_ns, st.st_mtime_ns + 6_000_000))
    with pytest.raises(ckpt.ForeignCheckpoint):
        poller.reload_if_changed(actor, log)


def test_mismatched_checkpoint_leaves_every_tensor_unchanged(tmp_path):
    """The weights and the hash matrix fit, the bitset does not: nothing
    may be copied (a load that copies as it goes would have changed every
    weight before it reached the bitset)."""
    src = new_agent(_tiny3(), seed=1, device="cpu")
    src["hash_bits"] = bitset_init(14)
    path = ckpt.save_checkpoint(tmp_path, "model_0000001.ckpt", src)
    dst = new_agent(_tiny3(), seed=2, device="cpu")
    before = {k: v.clone() for k, v in dst["net"].state_dict().items()}
    before_hash = {k: dst[k].clone() for k in ("hash_bits", "hash_matrix")}
    with pytest.raises(ckpt.CheckpointMismatch, match="hash_bits"):
        ckpt.load_checkpoint(path, dst)
    assert all(torch.equal(before[k], v) for k, v in dst["net"].state_dict().items())
    assert all(torch.equal(v, dst[k]) for k, v in before_hash.items())
    # A file without the novelty matrix, or with an unknown weight.
    state = ckpt.read_checkpoint(path)
    for broken in ({"net": state["net"]}, {**state, "hash_bits": dst["hash_bits"], "extra": torch.zeros(1)}):
        torch.save(broken, tmp_path / "broken.ckpt")
        with pytest.raises(ckpt.CheckpointMismatch):
            ckpt.load_checkpoint(tmp_path / "broken.ckpt", dst)
    assert all(torch.equal(before[k], v) for k, v in dst["net"].state_dict().items())


def test_backpressure_reads_the_jax_writer(tmp_path):
    d = str(tmp_path)
    assert not co.backpressure_hit(d, 0, 0)  # no file yet
    jax_co.write_buffer_lengths(d, 10, 5)
    assert co.backpressure_hit(d, 9, 0) and not co.backpressure_hit(d, 10, 0)
    assert co.backpressure_hit(d, 4, 1) and not co.backpressure_hit(d, 5, 1)
    co.wait_for_backpressure(d, 10, which=0, max_wait=0.0)  # returns at once
    co.wait_for_backpressure(d, 0, which=0, poll_seconds=0.01, max_wait=0.02)  # gives up
    (tmp_path / co.BUFFER_LENGTHS).write_text("10,5,16")  # bad checksum: no hit
    assert not co.backpressure_hit(d, 0, 0)


def test_step_trace_writes_after_the_skipped_iteration(tmp_path):
    trace = StepTrace(tmp_path / "prof", logging.getLogger("trace-test"), skip=1, steps=2)
    for i in range(5):
        trace.step()
        torch.ones(8).sum()
        if i == 0:
            assert trace.path is None and not (tmp_path / "prof").exists()
    trace.stop()
    assert trace.path is not None and trace.path.exists()
    assert "traceEvents" in json.loads(trace.path.read_text())
    off = StepTrace(None, logging.getLogger("trace-test"))
    off.step()
    off.stop()
    assert off.path is None


def _learn(d, *extra):
    return learn.main(["--directory", str(d), "--net", "tiny3", "--batch-size", "8",
                       "--no-wait", "--device", "cpu", *extra])


def test_actor_drivers_close_the_loop_on_the_cpu(tmp_path):
    d = tmp_path
    _learn(d, "--seed", "1", "--pretrain-targets", "32", "--pretrain-steps", "2", "--max-steps", "0",
           "--profile", str(d / "learn_prof"))
    sp = selfplay.main(["--directory", str(d), "--net", "tiny3", "--seed", "2", "--batch", "4",
                        "--budget", "16", "--sampled", "4", "--max-steps", "24", "--exploration",
                        "--device", "cpu", "--profile", str(d / "sp_prof"), "--dump-search",
                        str(d / "dump.txt")])
    assert sp["moves"] == 24 and sp["reloads"] == 1 and sp["replays"] > 0
    assert 0 < sp["host_seconds"] < sp["seconds"]
    assert list((d / "sp_prof").glob("trace_*.json"))
    assert len((d / "dump.txt").read_text().splitlines()) == 24
    idx, _ = jax_ckpt.read_hash_indices(d / ckpt.HASH_LOG, 0)
    seen = bitset_set(bitset_init(12), torch.from_numpy(idx.astype(np.int64)))
    assert torch.equal(sp["agent"]["hash_bits"], seen)

    text = (d / co.TARGETS_SELFPLAY).read_text()
    assert len(jax_nl.parse_targets(3, text)[1]) == text.count("\n") == sp["targets"]
    for name, count in ((co.REPLAYS, sp["replays"]), (co.REPLAYS_EXPLORATION, sp["exploration_replays"])):
        lines = (d / name).read_text().splitlines()
        assert len(lines) == count
        for line in lines:
            assert JaxReplay.from_line(3, line).to_line() == line

    stats = _learn(d, "--seed", "3", "--pretrain-steps", "0", "--max-steps", "2")
    assert stats["steps"] == 2
    # A second actor stops once a game has finished; it loads the new
    # model once and holds the seen-set of the whole log.
    sp2 = selfplay.main(["--directory", str(d), "--net", "tiny3", "--seed", "6", "--batch", "4",
                         "--budget", "16", "--sampled", "4", "--max-games", "1", "--device", "cpu"])
    assert sp2["replays"] >= 1 and sp2["moves"] < 24 and sp2["reloads"] == 1
    idx, _ = jax_ckpt.read_hash_indices(d / ckpt.HASH_LOG, 0)
    seen = bitset_set(bitset_init(12), torch.from_numpy(idx.astype(np.int64)))
    assert torch.equal(sp2["agent"]["hash_bits"], seen) and not torch.equal(seen, sp["agent"]["hash_bits"])
    assert not list((d / "learn_prof").glob("trace_*.json"))  # the pre-training run had no loop step

    re = reanalyze.main(["--directory", str(d), "--net", "tiny3", "--seed", "4", "--batch", "4",
                         "--budget", "16", "--sampled", "4", "--min-positions", "4", "--max-steps", "2",
                         "--device", "cpu"])
    assert re["steps"] == 2 and re["targets"] == 8 and re["reloads"] == 1
    text = (d / co.TARGETS_REANALYZE).read_text()
    assert len(jax_nl.parse_targets(3, text)[1]) == 8
    eng = torch_engine(3)
    for line in text.splitlines():
        t = Target.from_line(3, line)
        legal = eng.legal_mask(tps_to_state(3, t.tps).map(lambda x: x[None]))[0]
        assert sorted(a for a, _ in t.policy) == torch.nonzero(legal)[:, 0].tolist()
    # The learner mixes reanalyze targets only after step 5000: train one
    # step on them directly.
    agent = ckpt.load_checkpoint(ckpt.latest_path(d), new_agent(_tiny3(), seed=5, device="cpu"))
    batch = make_batch_native(eng, text, np.random.default_rng(0), device="cpu")
    m = make_train_step(_tiny3())(agent, make_optimizer(agent), batch, True)
    assert all(np.isfinite(float(v)) for v in m.values())

    stats = _learn(d, "--seed", "5", "--pretrain-steps", "0", "--max-steps", "3",
                   "--profile", str(d / "learn_prof"))
    assert stats["steps"] == 3 and list((d / "learn_prof").glob("trace_*.json"))


def test_actor_drivers_refuse_what_is_not_ported(tmp_path, monkeypatch):
    """Both actors take --devices (ROADMAP queue 1, item 5): a batch that N
    does not divide is a parser error, more cards than are visible raise,
    and --devices 1 runs one rank in this process.  What they still refuse
    is WORLD_SIZE > 1 without a process group (a torchrun launch past the
    multihost launcher, where every process would write)."""
    base = ["--directory", str(tmp_path), "--net", "tiny3", "--max-steps", "1", "--batch", "4"]
    for main in (selfplay.main, reanalyze.main):
        with pytest.raises(SystemExit):
            main(base + ["--device", "cpu", "--devices", "3"])
        with pytest.raises(ValueError, match="--devices 2 but only 0 visible"):
            main(base + ["--device", "cuda", "--devices", "2"])
    assert selfplay.main(base + ["--device", "cpu", "--devices", "1"])["moves"] == 1
    assert reanalyze.main(base + ["--device", "cpu", "--devices", "1"])["steps"] == 0  # no replays yet
    monkeypatch.setenv("WORLD_SIZE", "2")
    for main in (selfplay.main, reanalyze.main):
        with pytest.raises(RuntimeError, match="multihost"):
            main(base + ["--device", "cpu"])
    assert not any(tmp_path.iterdir())
