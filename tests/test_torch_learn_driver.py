"""The port's learner driver end to end, its checkpoints and hash log.

Mirrors the JAX driver's tests (``tests/test_drivers.py``,
``tests/test_hash_log.py``) on ``tiny3`` with ``--device cpu --no-wait``:

* pre-training writes ``model_0000000.ckpt``, the pre-trained step
  checkpoint, ``model_latest.ckpt``, ``targets-initial.txt`` (lines that
  JAX's ``Target.from_line`` reads) and ``hash_log.bin``;
* training on ``targets-selfplay.txt`` resumes from the highest step,
  writes per-step ``metrics.jsonl`` and ``buffer_lengths.txt`` (which
  JAX's ``read_buffer_lengths`` reads), and leaves a step checkpoint whose
  bitset equals the one rebuilt from ``hash_log.bin`` (JAX's reader);
* a later run resumes from that checkpoint;
* checkpoints round-trip, a weights-only file keeps the bitset; a JAX
  learner's flax msgpack file loads (the bridge's weights and seen-set),
  one of another width is refused, and so is a file of neither format;
* ``takzero_torch.bench`` benches a move from a learner checkpoint.
"""

import json

import jax
import numpy as np
import pytest
import torch

from takzero_tpu.data.target import Target as JaxTarget
from takzero_tpu.models import agent as jax_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.parallel import coordinator as jax_co
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.train.data import random_pretraining_targets as jax_random_targets
from takzero_tpu.utils import ckpt as jax_ckpt
from takzero_torch import bench
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.data.native_loader import make_batch_native
from takzero_torch.drivers import learn
from takzero_torch.models.agent import new_agent
from takzero_torch.models.network import NetConfig
from takzero_torch.ops.bitset import bitset_init, bitset_set
from takzero_torch.tak import engine as torch_engine
from takzero_torch.train.learner import make_optimizer, make_train_step
from takzero_torch.utils import ckpt

torch.set_num_threads(2)


def _learn(d, *extra):
    return learn.main(["--directory", str(d), "--net", "tiny3", "--batch-size", "8",
                       "--no-wait", "--device", "cpu", *extra])


def _bits_from_log(d, bits: int) -> np.ndarray:
    idx, _ = jax_ckpt.read_hash_indices(d / ckpt.HASH_LOG, 0)
    words = bitset_init(bits)
    bitset_set(words, torch.from_numpy(idx.astype(np.int64)))
    return words.numpy().view(np.uint32)


def _metrics(d):
    return [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]


def test_learn_driver_end_to_end(tmp_path):
    d = tmp_path
    _learn(d, "--seed", "1", "--pretrain-targets", "32", "--pretrain-steps", "2", "--max-steps", "0")
    for name in ("model_0000000.ckpt", "model_0000002.ckpt", "model_latest.ckpt", "hash_log.bin"):
        assert (d / name).exists(), name
    initial = (d / "targets-initial.txt").read_text().splitlines()
    assert len(initial) == 32
    for line in initial:
        assert JaxTarget.from_line(3, line).to_line() == line
    assert "hash_bits" not in ckpt.read_checkpoint(d / "model_latest.ckpt")
    pre = ckpt.read_checkpoint(d / "model_0000002.ckpt")["hash_bits"].numpy().view(np.uint32)
    np.testing.assert_array_equal(_bits_from_log(d, 12), pre)
    assert pre.any()

    lines = [t.to_line() for t in jax_random_targets(jax_engine(3), 48, np.random.default_rng(9))]
    (d / "targets-selfplay.txt").write_text("\n".join(lines) + "\nnot a target\n")
    stats = _learn(d, "--seed", "3", "--pretrain-steps", "0", "--max-steps", "6",
                   "--chunk-steps", "3", "--steps-per-checkpoint", "8")
    assert stats["steps"] == 6 and stats["assemble_seconds"] <= stats["seconds"]
    m = _metrics(d)
    assert [r["step"] for r in m] == list(range(3, 9))
    for r in m:
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_policy", "loss_value", "loss_ube"))
        assert r["loss_ube"] > 0
    assert jax_co.read_buffer_lengths(str(d)) == (48, 0)
    step8 = ckpt.read_checkpoint(d / "model_0000008.ckpt")
    np.testing.assert_array_equal(_bits_from_log(d, 12), step8["hash_bits"].numpy().view(np.uint32))
    latest = ckpt.read_checkpoint(d / "model_latest.ckpt")
    for k, v in step8["net"].items():
        assert torch.equal(latest["net"][k], v), k

    # Resume from the highest step checkpoint.
    _learn(d, "--seed", "4", "--pretrain-steps", "0", "--max-steps", "2")
    assert [r["step"] for r in _metrics(d)][-2:] == [9, 10]
    s8 = step8["hash_bits"].numpy().view(np.uint32)
    np.testing.assert_array_equal(_bits_from_log(d, 12) & s8, s8)


def test_learn_driver_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """--devices runs (ROADMAP queue 1, item 5): a batch that N does not
    divide is a parser error, more cards than are visible raise, and
    --devices 1 runs one rank in this process; WORLD_SIZE > 1 without a
    process group is refused."""
    with pytest.raises(SystemExit):
        _learn(tmp_path, "--batch-size", "6", "--devices", "4")
    with pytest.raises(ValueError, match="--devices 2 but only 0 visible"):
        learn.main(["--directory", str(tmp_path), "--net", "tiny3", "--device", "cuda", "--devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="multihost"):
        _learn(tmp_path)
    assert not any(tmp_path.iterdir())
    monkeypatch.delenv("WORLD_SIZE")
    stats = _learn(tmp_path, "--batch-size", "8", "--pretrain-targets", "16", "--pretrain-steps", "2",
                   "--max-steps", "0", "--no-wait", "--devices", "1")
    assert stats["steps"] == 0 and (tmp_path / "model_0000002.ckpt").exists()


def test_checkpoints_round_trip_and_refuse_flax_files(tmp_path):
    cfg = NET_PRESETS["tiny3"]
    a = new_agent(cfg, seed=1, device="cpu")
    bitset_set(a["hash_bits"], torch.tensor([3, 31, 4095]))
    ckpt.save_checkpoint(tmp_path, "model_0000005.ckpt", a)
    ckpt.save_checkpoint(tmp_path, "model_latest.ckpt", ckpt.strip_hash_bits(a))
    assert ckpt.model_path_with_most_steps(tmp_path) == (5, tmp_path / "model_0000005.ckpt")

    b = new_agent(cfg, seed=2, device="cpu")
    ckpt.load_checkpoint(tmp_path / "model_0000005.ckpt", b)
    for (k, x), y in zip(a["net"].state_dict().items(), b["net"].state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(a["hash_bits"], b["hash_bits"]) and torch.equal(a["hash_matrix"], b["hash_matrix"])
    assert "folded" not in b

    c = new_agent(cfg, seed=3, device="cpu")
    bitset_set(c["hash_bits"], torch.tensor([7]))
    before = c["hash_bits"].clone()
    ckpt.load_checkpoint(tmp_path / "model_latest.ckpt", c)  # weights only: bitset kept
    assert torch.equal(c["hash_bits"], before)

    # The saver snapshots at submit: a later in-place change is not saved.
    saver = ckpt.AsyncSaver()
    saver.submit(tmp_path, "model_0000006.ckpt", a)
    with torch.no_grad():
        a["net"].policy.bias.add_(1.0)
    saver.drain()
    saved = ckpt.read_checkpoint(tmp_path / "model_0000006.ckpt")
    assert torch.equal(saved["net"]["policy.bias"], b["net"].policy.bias)

    wrong = new_agent(NetConfig(n=3, half_komi=0, filters=8, blocks=1, hash_bits=12), device="cpu")
    with pytest.raises(RuntimeError):
        ckpt.load_checkpoint(tmp_path / "model_0000005.ckpt", wrong)

    # A JAX learner's flax msgpack file loads; one of another width, or a
    # file of neither format, is refused and changes nothing.
    jcfg = jax_network.NetConfig(n=3, half_komi=0, filters=16, blocks=2, hash_bits=12)
    jbundle = jax.tree.map(np.asarray, jax_agent.new_agent(jcfg))
    jax_ckpt.save_checkpoint(tmp_path, "jax.ckpt", jbundle)
    ckpt.load_checkpoint(tmp_path / "jax.ckpt", b)
    want = from_jax_bundle(jbundle, cfg, device="cpu")
    for (k, x), y in zip(b["net"].state_dict().items(), want["net"].state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(b["hash_bits"], want["hash_bits"]) and torch.equal(b["hash_matrix"], want["hash_matrix"])
    jax_ckpt.save_checkpoint(tmp_path, "jax_wide.ckpt", jax.tree.map(
        np.asarray, jax_agent.new_agent(jax_network.NetConfig(n=3, half_komi=0, filters=24, blocks=2, hash_bits=12))))
    with pytest.raises(ckpt.CheckpointMismatch):
        ckpt.load_checkpoint(tmp_path / "jax_wide.ckpt", b)
    (tmp_path / "other.ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(ckpt.ForeignCheckpoint):
        ckpt.load_checkpoint(tmp_path / "other.ckpt", b)
    assert torch.equal(b["net"].policy.bias, want["net"].policy.bias)


def test_bench_runs_a_move_from_a_learner_checkpoint(tmp_path, monkeypatch):
    """A learner checkpoint at tiny3 width on the bench's 6x6 board (the
    bench plays 6x6); one train step, then one benched move from it."""
    cfg = NetConfig(n=6, half_komi=4, filters=8, blocks=1, hash_bits=12)
    agent = new_agent(cfg, seed=5, device="cpu")
    lines = [t.to_line() for t in jax_random_targets(jax_engine(6, half_komi=4), 8, np.random.default_rng(5))]
    batch = make_batch_native(torch_engine(6, half_komi=4), "\n".join(lines) + "\n",
                              np.random.default_rng(5), device="cpu")
    make_train_step(cfg)(agent, make_optimizer(agent), batch, True)
    path = ckpt.save_checkpoint(tmp_path, "model_0000001.ckpt", agent)

    monkeypatch.setenv("TAKZERO_BENCH_CKPT", str(path))
    bcfg = bench.BenchConfig.from_env()
    assert bcfg.ckpt == str(path)
    bcfg = bench.BenchConfig(batch=2, budget=6, sampled=2, moves=1, filters=8, blocks=1, ckpt=str(path))
    st = bench.setup(bcfg, device="cpu")
    for (k, x), y in zip(agent["net"].state_dict().items(), st.agent["net"].state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(st.agent["hash_bits"], agent["hash_bits"])
    res = bench.run(bcfg, device="cpu")
    assert len(res.per_move_s) == 1 and res.sims_per_s > 0
    assert "trained ckpt" in res.json_line()["unit"]
