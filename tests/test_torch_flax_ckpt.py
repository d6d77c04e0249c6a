"""A JAX run's checkpoint in the port: ``takzero_torch/utils/flax_msgpack.py``
(a msgpack decoder of its own, flax's ext types and chunked arrays) and the
loaders of ``takzero_torch/utils/ckpt.py`` on files that JAX's
``save_checkpoint`` writes here, where flax and msgpack are installed.

* Every msgpack format flax writes, and flax's ext types (ndarray of each
  dtype, bfloat16 included, native complex, numpy scalar), decode to what
  ``msgpack.unpackb`` with flax's ext hook gives.
* A bundle file of a SimHash net (with its seen-set, and with
  ``strip_hash_bits``) and of an RND net (conv tower, and MLP): every leaf
  equals ``flax.serialization.msgpack_restore``'s, dtype and bits.  The
  bundle ``load_checkpoint`` builds from the file evaluates 16 positions
  to JAX's outputs within 1e-4 in float32 (the tolerance of
  ``tests/test_torch_novelty.py::test_net_evaluate_matches_jax``) and
  equals ``bridge.from_jax_bundle``'s tensor for tensor.
* Arrays above flax's ``MAX_CHUNK_SIZE`` (set small inside the test) come
  back joined.
* ``load_checkpoint_partial`` keeps JAX's tolerance: a file of another
  width loads the leaves that fit and keeps the bundle's others; a
  truncated file raises, a file of neither format raises
  ``ForeignCheckpoint``.
* The committed fixture of ``chip_smoke.py`` phase 17b
  (``tests/data/jax_model_4x4.ckpt``, a float32 4x4 16x2 SimHash net that
  JAX's ``save_checkpoint`` wrote, and ``jax_model_4x4_outputs.npz``, its
  JAX outputs on 16 positions) is what :func:`write_fixture` writes now,
  and the port evaluates it to those outputs within 1e-4.  Rewrite both
  with ``python tests/test_torch_flax_ckpt.py``.
"""

import logging
import pathlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from takzero_tpu.models import agent as jax_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import tps_to_state as jax_tps_to_state
from takzero_tpu.utils import ckpt as jax_ckpt
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.models import agent as torch_agent
from takzero_torch.models import network as torch_network
from takzero_torch.search.openings import make_new_opening
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tak.tps import states_to_tps, tps_to_state
from takzero_torch.utils import ckpt, flax_msgpack

from torch_parity import state_to_jax

torch.set_num_threads(2)

TINY = dict(filters=16, blocks=2, hash_bits=12, rnd_filters=8, rnd_blocks=1)
CASES = {
    "simhash": (dict(novelty="simhash"), False),
    "simhash-stripped": (dict(novelty="simhash"), True),
    "rnd": (dict(novelty="rnd"), False),
    "rnd-stripped": (dict(novelty="rnd"), True),
    "rnd_mlp": (dict(novelty="rnd", rnd_mlp=True), False),
}


def _configs(**kw):
    kw = {**TINY, **kw}
    return (jax_network.NetConfig(n=3, half_komi=0, compute_dtype=jnp.float32, **kw),
            torch_network.NetConfig(n=3, half_komi=0, compute_dtype=torch.float32, **kw))


def _perturbed(bundle, seed: int):
    """BatchNorm statistics, scales and biases moved off their
    initialisation and half the seen-set set, so that every leaf counts."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        leaf = jax.tree_util.keystr(path)
        x = np.array(x)
        if "'var'" in leaf:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if any(s in leaf for s in ("'mean'", "'scale'", "'bias'")):
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x

    out = jax.tree.map(np.asarray, dict(bundle))
    for key in ("params", "batch_stats", "rnd_params", "rnd_batch_stats"):
        if key in out:
            out[key] = jax.tree_util.tree_map_with_path(perturb, out[key])
    if "hash_bits" in out:
        out["hash_bits"] = rng.integers(0, 2**32, out["hash_bits"].shape, dtype=np.uint32)
    if "rnd_min" in out:
        out["rnd_min"], out["rnd_max"] = np.float32(0.01), np.float32(2.5)
    return out


def _envs(batch: int = 16, seed: int = 9, plies: int = 6):
    eng = torch_engine(3)
    gen = torch.Generator().manual_seed(seed)
    sym, pair = torch.randint(0, 8, (batch,), generator=gen), torch.randint(0, 2, (batch,), generator=gen)
    return make_new_opening(eng, random_steps=plies)(sym, pair, gumbel_noise(gen, (plies, batch, eng.num_actions)))


def _leaves_equal(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.name == "bfloat16":  # widened exactly to float32
        want = want.astype(np.float32)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def test_decoder_reads_every_format_flax_writes():
    objs = [
        None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
        0.5, -1e300, float("inf"), "", "a" * 31, "b" * 32, "é" * 200, "c" * 70000,
        b"", b"\x00" * 300, b"\x01" * 70000, [], list(range(15)), list(range(16)), list(range(70000)),
        {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)}, {str(i): [i] for i in range(70000)},
        {"nested": {"list": [1, "two", 3.0, None], "map": {"k": b"v"}}},
        complex(1.5, -2.0), np.float32(0.25), np.int64(-3), np.bool_(True),
        np.arange(6, dtype=np.int8).reshape(2, 3), np.arange(4, dtype=np.uint32), np.zeros((0, 2), np.float32),
        np.linspace(-1, 1, 12, dtype=np.float64).reshape(3, 4), np.array(3.5, np.float32),
        np.array([1.5, -2.25, 3.0], dtype=jnp.bfloat16),
    ]
    for obj in objs:
        data = msgpack.packb(obj, default=serialization._msgpack_ext_pack, strict_types=True, use_bin_type=True)
        want = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False)
        got = flax_msgpack.unpackb(data)
        if isinstance(want, np.ndarray) or isinstance(want, np.generic):
            _leaves_equal(got, want)
            assert isinstance(got, np.generic) == isinstance(want, np.generic)
        else:
            assert type(got) is type(want) and got == want, repr(obj)[:60]
    packed = msgpack.packb(np.array([1.0, 2.0], np.float32), default=serialization._msgpack_ext_pack)
    for broken in (packed[:-1], packed + b"\x00", b"\xc1", msgpack.packb(msgpack.ExtType(9, b"x"))):
        with pytest.raises(flax_msgpack.MsgpackError):
            flax_msgpack.unpackb(broken)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_loads_and_evaluates_to_jax(case, tmp_path):
    kw, strip = CASES[case]
    jcfg, tcfg = _configs(**kw)
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=8), seed=8)
    saved = jax_ckpt.strip_hash_bits(jbundle) if strip else jbundle
    path = jax_ckpt.save_checkpoint(str(tmp_path), "model_0000005.ckpt", saved)
    raw = path.read_bytes()
    _leaves_equal(flax_msgpack.restore(raw), serialization.msgpack_restore(raw))

    bundle = ckpt.load_checkpoint(path, torch_agent.new_agent(tcfg, seed=1, device="cpu"))
    want_bundle = from_jax_bundle(jbundle, tcfg, device="cpu")
    for key in ("net", "rnd"):
        if key in bundle:
            want_sd = want_bundle[key].state_dict()
            for name, x in bundle[key].state_dict().items():
                assert torch.equal(x, want_sd[name]), f"{key}.{name}"
    for key in ("hash_matrix", "rnd_min", "rnd_max"):
        if key in bundle:
            assert torch.equal(bundle[key], want_bundle[key]), key
    if "hash_bits" in bundle:
        # A stripped file keeps the bundle's own (empty) seen-set.
        assert torch.equal(bundle["hash_bits"], torch.zeros_like(bundle["hash_bits"]) if strip
                           else want_bundle["hash_bits"])
    envs = _envs()
    got = torch_agent.make_net_evaluate(tcfg, torch_engine(3), device="cpu")(bundle, envs)
    jb = jax.tree.map(jnp.asarray, jbundle)
    if strip and "hash_bits" in jb:
        jb["hash_bits"] = jnp.zeros_like(jb["hash_bits"])
    want = jax.jit(jax_agent.make_net_evaluate(jcfg, jax_engine(3)))(jb, state_to_jax(envs))
    for g, w, what in zip(got, want, ("logits", "value", "variance")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=what)
    assert ckpt.read_checkpoint(path).keys() == ckpt.checkpoint_state(
        ckpt.strip_hash_bits(bundle) if strip else bundle).keys()


def test_chunked_arrays_come_back_joined(tmp_path, monkeypatch):
    jcfg, tcfg = _configs(novelty="simhash")
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=3), seed=3)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)  # bytes: the seen-set and the big kernels chunk
    path = jax_ckpt.save_checkpoint(str(tmp_path), "model_0000001.ckpt", jbundle)
    raw = path.read_bytes()
    plain = flax_msgpack.unpackb(raw)
    assert plain["hash_bits"]["__msgpack_chunked_array__"] and len(plain["hash_bits"]["chunks"]) == 2
    restored = flax_msgpack.restore(raw)
    _leaves_equal(restored, serialization.msgpack_restore(raw))
    assert restored["hash_bits"].shape == (128,) and restored["hash_matrix"].shape == (216, 12)
    bundle = ckpt.load_checkpoint(path, torch_agent.new_agent(tcfg, seed=1, device="cpu"))
    assert torch.equal(bundle["hash_bits"], from_jax_bundle(jbundle, tcfg, device="cpu")["hash_bits"])


def test_partial_load_of_a_jax_file_keeps_what_does_not_fit(tmp_path, caplog):
    jcfg, _ = _configs(novelty="simhash")
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=4), seed=4)
    path = jax_ckpt.save_checkpoint(str(tmp_path), "model_0000002.ckpt", jbundle)
    # A bundle of another width: only the heads' biases and the hash fit.
    _, wide = _configs(novelty="simhash", filters=24)
    dst = torch_agent.new_agent(wide, seed=2, device="cpu")
    before = {k: v.clone() for k, v in dst["net"].state_dict().items()}
    with caplog.at_level(logging.WARNING):
        out = ckpt.load_checkpoint_partial(path, dst)
    assert out is dst
    assert torch.equal(dst["net"].state_dict()["core.stem.conv.weight"], before["core.stem.conv.weight"])
    assert torch.equal(dst["net"].value.dense.bias, torch.from_numpy(np.array(jbundle["params"]["value"]["Dense_0"]["bias"])))
    assert torch.equal(dst["hash_matrix"], torch.from_numpy(np.array(jbundle["hash_matrix"])))
    assert "core.stem.conv.weight" in caplog.text
    with pytest.raises(ckpt.CheckpointMismatch):
        ckpt.load_checkpoint(path, torch_agent.new_agent(wide, seed=2, device="cpu"))
    (tmp_path / "torn.ckpt").write_bytes(path.read_bytes()[:100])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_checkpoint_partial(tmp_path / "torn.ckpt", dst)
    (tmp_path / "other.ckpt").write_bytes(b"GARBAGE!")
    with pytest.raises(ckpt.ForeignCheckpoint):
        ckpt.load_checkpoint_partial(tmp_path / "other.ckpt", dst)


DATA = pathlib.Path(__file__).parent / "data"
FIXTURE_CFG = dict(n=4, half_komi=4, filters=16, blocks=2, novelty="simhash", hash_bits=12)


def write_fixture(directory) -> tuple[pathlib.Path, pathlib.Path]:
    """JAX's checkpoint of a perturbed float32 4x4 SimHash net (half of 16
    random positions in its seen-set), and an ``.npz`` of those positions'
    TPS, the config and JAX's (logits, value, variance) on them."""
    directory = pathlib.Path(directory)
    n = FIXTURE_CFG["n"]
    jcfg = jax_network.NetConfig(compute_dtype=jnp.float32, **FIXTURE_CFG)
    eng = torch_engine(n, half_komi=FIXTURE_CFG["half_komi"])
    gen = torch.Generator().manual_seed(21)
    sym, pair = torch.randint(0, 8, (16,), generator=gen), torch.randint(0, 2, (16,), generator=gen)
    envs = make_new_opening(eng, random_steps=10)(sym, pair, gumbel_noise(gen, (10, 16, eng.num_actions)))
    tps = states_to_tps(n, envs)
    jstates = jax.tree.map(lambda *x: jnp.stack(x), *(jax_tps_to_state(n, t) for t in tps))
    jeng = jax_engine(n, half_komi=FIXTURE_CFG["half_komi"])
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=21), seed=21)
    jbundle["hash_bits"] = np.zeros_like(jbundle["hash_bits"])
    from takzero_tpu.ops.repr import state_to_planes as jax_planes

    planes = jax.vmap(lambda s: jax_planes(jeng, s))(jax.tree.map(lambda x: x[:8], jstates))
    jbundle = jax.tree.map(np.asarray, jax_agent.hash_update(jcfg, jax.tree.map(jnp.asarray, jbundle), planes))
    ckpt_path = jax_ckpt.save_checkpoint(str(directory), "jax_model_4x4.ckpt", jbundle)
    logits, value, variance = (np.asarray(x) for x in jax.jit(jax_agent.make_net_evaluate(jcfg, jeng))(
        jax.tree.map(jnp.asarray, jbundle), jstates))
    out = directory / "jax_model_4x4_outputs.npz"
    np.savez(out, tps=np.array(tps), logits=logits, value=value, variance=variance,
             **{k: np.array(v) for k, v in FIXTURE_CFG.items()})
    return pathlib.Path(ckpt_path), out


def test_committed_fixture_is_jaxs(tmp_path):
    path, outputs = write_fixture(tmp_path)
    assert path.read_bytes() == (DATA / "jax_model_4x4.ckpt").read_bytes()
    got, want = np.load(outputs), np.load(DATA / "jax_model_4x4_outputs.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k) if got[k].dtype.kind == "f" \
            else np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The port: the file, evaluated on the TPS (chip_smoke.py phase 17b's check on the CPU).
    tcfg = torch_network.NetConfig(compute_dtype=torch.float32, **FIXTURE_CFG)
    bundle = ckpt.load_checkpoint(DATA / "jax_model_4x4.ckpt", torch_agent.new_agent(tcfg, seed=0, device="cpu"))
    envs = [tps_to_state(tcfg.n, t) for t in want["tps"]]
    envs = type(envs[0])(*(torch.stack(x) for x in zip(*envs)))
    res = torch_agent.make_net_evaluate(tcfg, torch_engine(tcfg.n, half_komi=tcfg.half_komi), device="cpu")(
        bundle, envs)
    for g, name in zip(res, ("logits", "value", "variance")):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4, atol=1e-4, err_msg=name)
    # The eight positions in the seen-set are seen (SimHash may also put a
    # similar unseen one into a seen bucket).
    assert (want["variance"][:8] < 4).all() and (want["variance"][8:] == 4).sum() >= 4


if __name__ == "__main__":
    for written in write_fixture(DATA):
        print(written, written.stat().st_size)
