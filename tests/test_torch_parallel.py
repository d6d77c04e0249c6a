"""The port's data parallelism (``takzero_torch/parallel``) against the JAX package's.

Two gloo ranks on the CPU (``multihost.run_ranks``, a ``file://``
rendezvous, one thread each) run the cases of ``tests/torch_ranks.py``
once for the module; the JAX side runs on the virtual CPU mesh of
``tests/conftest.py``, two devices of it.

* One train step of the tiny3 net from one bridged JAX bundle on a batch of
  16, against JAX's ``make_train_step`` under GSPMD with the batch sharded
  over two devices (``tests/test_parallel.py``'s placement), with
  ``train_ube`` False and True.  In float32: the loss within 1e-5
  relative, the parameters within 2e-5, the BatchNorm running statistics
  within 1e-6.  Adam's first step moves an entry by lr * sign(g), so an
  entry whose gradient is at rounding level may move the other way: every
  entry off by more than 2e-5 must have a JAX gradient below 1e-6 (as in
  ``tests/test_torch_learner.py``).  The tiny3 preset itself computes in
  bf16, where a float32 sum that lands within rounding of a bf16 boundary
  rounds either way: held to 5e-2, the bf16 tolerance of
  ``tests/test_torch_learner.py``.  Both ranks' parameters and statistics
  are bit-identical in every case, and the seen-set equals JAX's.
* The same step with the RND predictor (tiny3_rnd, float32).
* ``hash_update`` on two ranks, each hashing its rows: the bitset equals
  JAX's ``hash_update(..., axis_name)`` under ``shard_map`` on both ranks
  (SimHash and LCG hash).
* The collectives: rank 0's scalar and lines on every rank, the gathers in
  rank order, the flat sum and the mean equal on both ranks.
* Ranks build bit-identical weights from one seed (JAX's ``replicate`` has
  no counterpart).
* ``coordinated_backpressure``, ``process_batch_slice`` and the drivers'
  ``--devices`` errors against JAX's functions on the same inputs.
* The actors' padded evaluator (``World.at_global_shape``): on two ranks
  the bf16 tiny3 evaluator gives world 1's bits for every row; the rows
  sit at their global offset with zeros elsewhere, and only the real rows
  reach the hash.
"""

import argparse
import dataclasses
import functools
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.data import native_loader as jax_loader
from takzero_tpu.models import agent as jax_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.parallel import coordinator as jax_co
from takzero_tpu.parallel import mesh as jax_mesh
from takzero_tpu.parallel import multihost as jax_multihost
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.train import learner as jax_learner
from takzero_tpu.train.data import random_pretraining_targets as jax_random_targets
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.models import agent as torch_agent
from takzero_torch.models.network import NetConfig
from takzero_torch.parallel import coordinator as co
from takzero_torch.parallel import mesh as pm
from takzero_torch.parallel import multihost
from takzero_torch.tak.engine import engine as torch_engine
from takzero_torch.tak.state import where_state

import torch_ranks

torch.set_num_threads(2)

# (name, JAX preset, compute dtype, train_ube, tolerance)
TRAIN_CASES = [
    ("float32-no-ube", "tiny3", "float32", False, 1e-5),
    ("float32-ube", "tiny3", "float32", True, 1e-5),
    ("bfloat16-ube", "tiny3", "bfloat16", True, 5e-2),
    ("rnd-float32", "tiny3_rnd", "float32", True, 1e-5),
]
HASH_CASES = [("simhash", 12), ("lcghash", 10)]


def _perturbed(bundle, seed: int):
    """BatchNorm statistics, scales and biases moved off their identity
    initialisation, so that the running statistics count."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        leaf = jax.tree_util.keystr(path)
        x = np.array(x)
        if "'var'" in leaf:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if any(s in leaf for s in ("'mean'", "'scale'", "'bias'")):
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x

    out = dict(bundle)
    for key in ("params", "batch_stats", "rnd_params", "rnd_batch_stats"):
        if key in out:
            out[key] = jax.tree_util.tree_map_with_path(perturb, out[key])
    return jax.tree.map(jnp.asarray, out)


def _configs(preset: str, dtype: str):
    jcfg = dataclasses.replace(JAX_PRESETS[preset], compute_dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(NET_PRESETS[preset], compute_dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _batch(size: int, seed: int):
    eng = jax_engine(3, half_komi=0)
    rng = np.random.default_rng(seed)
    lines = [t.to_line() for t in jax_random_targets(eng, size, rng)]
    return jax_loader.make_batch_native(eng, "\n".join(lines) + "\n", rng)


@functools.partial(jax.jit, static_argnums=(0, 3))
def _jax_grads(jcfg, bundle, jb, train_ube):
    """JAX's gradients of the train loss on the global batch: (params, rnd_params or None)."""
    rnd = jcfg.novelty == "rnd"

    def full(trainable):
        params = trainable[0] if rnd else trainable
        loss, _ = jax_learner.loss_fn(jcfg, params, bundle["batch_stats"], jb, train_ube)
        if rnd:
            err, _ = jax_network.RndPair(jcfg).apply(
                {"params": trainable[1], "batch_stats": bundle["rnd_batch_stats"]}, jb.planes, train=True,
                mutable=["batch_stats"])
            loss = loss + jnp.mean(err)
        return loss

    g = jax.grad(full)((bundle["params"], bundle["rnd_params"]) if rnd else bundle["params"])
    return g if rnd else (g, None)


def _torch_layout(jbundle, tcfg, **trees):
    """JAX trees in the torch layout: (net state dict, RND state dict or None)."""
    b = dict(jax.tree.map(np.asarray, jbundle))
    b.update(jax.tree.map(np.asarray, trees))
    out = from_jax_bundle(b, tcfg, device="cpu")
    return ({k: v.numpy() for k, v in out["net"].state_dict().items()},
            {k: v.numpy() for k, v in out["rnd"].state_dict().items()} if "rnd" in out else None)


def _jax_sharded_step(jcfg, jbundle, jb, train_ube, mesh):
    tx = jax_learner.make_optimizer()
    step = jax.jit(jax_learner.make_train_step(jcfg, tx), static_argnames=("train_ube",))
    opt = jax_mesh.replicate(mesh, jax_learner.init_opt(jcfg, tx, jbundle))
    return step(jax_mesh.replicate(mesh, jbundle), opt, jax_mesh.shard_batch(mesh, jb), train_ube=train_ube)


def _hash_planes(n: int = 16):
    eng = jax_engine(3, half_komi=0)
    rng = np.random.default_rng(21)
    lines = [t.to_line() for t in jax_random_targets(eng, n, rng)]
    return np.asarray(jax_loader.make_batch_native(eng, "\n".join(lines) + "\n", rng).planes)


def _random_envs(cfg, batch: int, seed: int, plies: int = 8):
    """Positions of random playouts of random length on the CPU."""
    eng = torch_engine(cfg.n, half_komi=cfg.half_komi)
    gen = torch.Generator().manual_seed(seed)
    envs = eng.initial(batch)
    stop = torch.randint(0, plies + 1, (batch,), generator=gen)
    for p in range(plies):
        legal = eng.legal_mask(envs)
        live = (p < stop) & (eng.terminal_kind(envs) == 0) & legal.any(-1)
        act = torch.multinomial((legal | ~legal.any(-1, keepdim=True)).float(), 1, generator=gen)[:, 0]
        envs = where_state(live, eng.step(envs, act), envs)
    return envs


@pytest.fixture(scope="module")
def mesh():
    return jax_mesh.make_mesh(2)


@pytest.fixture(scope="module")
def cases(mesh, tmp_path_factory):
    """Both sides of every case: ``(jax results, [rank 0's, rank 1's])``."""
    inputs, torch_cases = [], {"train": [], "hash": [], "fresh_cfg": NET_PRESETS["tiny3"]}
    for i, (_, preset, dtype, train_ube, _) in enumerate(TRAIN_CASES):
        jcfg, tcfg = _configs(preset, dtype)
        jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=30 + i), seed=30 + i)
        jb = _batch(16, seed=40 + i)
        inputs.append((jcfg, tcfg, jbundle, jb, train_ube))
        torch_cases["train"].append({"cfg": tcfg, "bundle": jax.tree.map(np.asarray, jbundle),
                                     "batch": [np.asarray(x) for x in jb], "train_ube": train_ube})
    torch_cases["evaluate"] = {"cfg": NET_PRESETS["tiny3"], "seed": 12,
                               "envs": [x.numpy() for x in _random_envs(NET_PRESETS["tiny3"], 16, seed=13)]}
    planes = _hash_planes()
    hash_bundles = []
    for novelty, bits in HASH_CASES:
        jcfg = jax_network.NetConfig(n=3, half_komi=0, filters=8, blocks=1, novelty=novelty, hash_bits=bits)
        tcfg = NetConfig(n=3, half_komi=0, filters=8, blocks=1, novelty=novelty, hash_bits=bits)
        hash_bundles.append((jcfg, jax_agent.new_agent(jcfg, seed=5)))
        torch_cases["hash"].append({"cfg": tcfg, "bundle": jax.tree.map(np.asarray, hash_bundles[-1][1]),
                                    "planes": planes})
    path = tmp_path_factory.mktemp("ranks") / "cases.pkl"
    with open(path, "wb") as f:
        pickle.dump(torch_cases, f)
    jax_out = {"train": [], "hash": []}
    for jcfg, tcfg, jbundle, jb, train_ube in inputs:
        b, _, m = _jax_sharded_step(jcfg, jbundle, jb, train_ube, mesh)
        grads = None
        if jcfg.compute_dtype == jnp.float32:
            g_net, g_rnd = _jax_grads(jcfg, jbundle, jb, train_ube)
            grads = _torch_layout(jbundle, tcfg, params=g_net, **({} if g_rnd is None else {"rnd_params": g_rnd}))
        jax_out["train"].append({
            "metrics": {k: float(v) for k, v in m.items()},
            "state": _torch_layout(b, tcfg),
            "grads": grads,
            "hash_bits": np.asarray(b["hash_bits"]).view(np.int32) if "hash_bits" in b else None,
        })
    for jcfg, jbundle in hash_bundles:
        f = shard_map(lambda b, p, jcfg=jcfg: jax_agent.hash_update(jcfg, b, p, axis_name="dp")["hash_bits"][None],
                      mesh=mesh, in_specs=(P(), P("dp")), out_specs=P("dp"), check_rep=False)
        per_dev = np.asarray(f(jbundle, jnp.asarray(planes)))
        assert (per_dev == per_dev[0]).all() and per_dev[0].any()
        jax_out["hash"].append(per_dev[0].view(np.int32))
    ranks = multihost.run_ranks(torch_ranks.parallel_cases, str(path), 2, "gloo",
                                init_method=f"file://{path.parent / 'rendezvous'}", threads=1)
    assert [r["rank"] for r in ranks] == [0, 1] and {r["size"] for r in ranks} == {2}
    return jax_out, ranks


@pytest.mark.parametrize("index", range(len(TRAIN_CASES)), ids=[c[0] for c in TRAIN_CASES])
def test_two_rank_train_step_matches_jax_sharded(cases, index):
    jax_out, ranks = cases
    tol = TRAIN_CASES[index][4]
    want, got = jax_out["train"][index], [r["train"][index] for r in ranks]
    # Both ranks hold the same bits: the same gradients went through Adam.
    for part in ("net", "rnd"):
        if got[0][part] is not None:
            for name, x in got[0][part].items():
                np.testing.assert_array_equal(x, got[1][part][name], err_msg=f"{part}.{name} differs between ranks")
    assert got[0]["metrics"] == got[1]["metrics"]
    assert set(got[0]["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], w, rtol=tol, atol=tol if tol > 1e-5 else 0, err_msg=k)
    stats_tol = 1e-6 if tol == 1e-5 else tol
    flipped = 0
    for part, w_sd, g_sd, grads in zip(("net", "rnd"), want["state"], (got[0]["net"], got[0]["rnd"]),
                                       want["grads"] or (None, None)):
        if w_sd is None:
            continue
        for name, w in w_sd.items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g_sd[name], w, rtol=stats_tol, atol=stats_tol, err_msg=f"{part}.{name}")
            elif grads is not None and name in grads:
                off = np.abs(g_sd[name] - w) > 2e-5
                assert not (off & ~(np.abs(grads[name]) < 1e-6)).any(), (part, name, np.abs(g_sd[name] - w).max())
                flipped += int(off.sum())
    print(f"entries off by more than 2e-5 (JAX gradient below 1e-6): {flipped}")
    if want["hash_bits"] is not None:
        for g in got:
            np.testing.assert_array_equal(g["hash_bits"], want["hash_bits"])


@pytest.mark.parametrize("index", range(len(HASH_CASES)), ids=[c[0] for c in HASH_CASES])
def test_two_rank_hash_update_matches_jax_shard_map(cases, index):
    jax_out, ranks = cases
    for r in ranks:
        np.testing.assert_array_equal(r["hash"][index], jax_out["hash"][index], err_msg=f"rank {r['rank']}")


def test_collectives_on_two_ranks(cases):
    _, ranks = cases
    for r in ranks:
        assert r["scalar"] == 1000
        assert r["lines"] == [f"line {i} of rank 0" for i in range(3)]
        assert r["no_lines"] == []
        assert r["gather"] == [0, 1, 2, 10, 11, 12]
        assert r["gather_dim1"] == [[0, 1], [0, 1]]
        assert r["gather_bool"] == [True, True, False, True]
        assert r["flat"] == [[[3.0, 3.0], [3.0, 3.0]], [0.0, 3.0, 6.0]]
        assert r["mean"] == 0.5
    assert [r["batch_slice"] for r in ranks] == [(32, 0), (32, 32)]


def test_ranks_build_identical_weights_from_one_seed(cases):
    _, (r0, r1) = cases
    assert r0["fresh"].keys() == r1["fresh"].keys()
    for name, x in r0["fresh"].items():
        np.testing.assert_array_equal(x, r1["fresh"][name], err_msg=name)


def test_broadcast_scalar_keeps_the_int32_range():
    assert multihost.broadcast_scalar(2**31 - 1) == 2**31 - 1
    assert multihost.broadcast_scalar(-(2**31)) == -(2**31)
    for bad in (2**31, -(2**31) - 1):
        with pytest.raises(OverflowError):
            multihost.broadcast_scalar(bad)
    assert multihost.broadcast_lines(["a", "b"]) == ["a", "b"] and multihost.broadcast_lines(None) == []


class _FakeMulti:
    """A ``multi`` module stand-in: ``broadcast_scalar`` returns the
    coordinator's decisions from a script (the coordinator's own value
    when the script is empty) and records what it was given."""

    def __init__(self, script=()):
        self.script = list(script)
        self.given = []

    def broadcast_scalar(self, v):
        self.given.append(int(v))
        return self.script.pop(0) if self.script else int(v)


@pytest.mark.parametrize("coord,script,lengths,max_wait", [
    (True, (), [(900, 0), (900, 0), (10, 0)], None),  # over the limit twice, then clear
    (True, (), [(900, 0)] * 10, 3.0),  # gives up after max_wait
    (False, (0, 0, 1), [], None),  # a follower sleeps while rank 0 says so
    (True, (), [(900, 0), None, (10, 0)], None),  # a torn file is no hit
])
def test_coordinated_backpressure_matches_jax(tmp_path, monkeypatch, coord, script, lengths, max_wait):
    runs = {}
    for name, mod in (("jax", jax_co), ("torch", co)):
        multi, sleeps = _FakeMulti(script), []
        queue = list(lengths)

        def sleep(s, sleeps=sleeps, queue=queue):
            sleeps.append(s)
            if queue:
                queue.pop(0)

        def lengths_now(directory, queue=queue):
            return queue[0] if queue else (0, 0)

        monkeypatch.setattr(mod.time, "sleep", sleep)
        monkeypatch.setattr(mod, "read_buffer_lengths", lengths_now)
        mod.coordinated_backpressure(multi, coord, tmp_path, 100, 0, max_wait)
        runs[name] = (multi.given, sleeps)
    assert runs["torch"] == runs["jax"]
    assert len(runs["jax"][1]) > 0


def test_process_batch_slice_matches_jax(monkeypatch):
    for n in (1, 2, 4, 8):
        for i in range(n):
            monkeypatch.setattr(jax, "process_count", lambda n=n: n)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            monkeypatch.setattr(multihost, "world_size", lambda n=n: n)
            monkeypatch.setattr(multihost, "rank", lambda i=i: i)
            assert multihost.process_batch_slice(64) == jax_multihost.process_batch_slice(64)
    with pytest.raises(AssertionError, match="multiple of the 8"):
        multihost.process_batch_slice(12)
    with pytest.raises(AssertionError, match="multiple of the 8"):
        jax_multihost.process_batch_slice(12)


def test_driver_world_errors_match_driver_mesh(capsys):
    log = logging.getLogger("test")
    messages = []
    for fn in (lambda p: jax_mesh.driver_mesh(p, 4, 6, log, "--batch"),
               lambda p: pm.driver_world(p, 4, 6, log, "--batch", "cpu")):
        with pytest.raises(SystemExit):
            fn(argparse.ArgumentParser(prog="driver"))
        messages.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert messages[0] == messages[1] == "driver: error: --batch 6 not divisible by --devices 4"
    # More devices than visible: JAX's virtual CPU mesh has 8, this host no card.
    with pytest.raises(ValueError, match=r"^--devices 9 but only 8 visible$"):
        jax_mesh.make_mesh(9)
    with pytest.raises(ValueError, match=r"^--devices 2 but only 0 visible$"):
        pm.make_world(2, "cuda")
    assert pm.make_world(3, "cpu") == [torch.device("cpu")] * 3
    world = pm.driver_world(argparse.ArgumentParser(), 2, 8, log, "--batch", "cpu")
    assert (world.size, world.launch, world.active) == (2, True, False)
    single = pm.driver_world(argparse.ArgumentParser(), None, 7, log, "--batch", "cpu")
    assert (single.size, single.launch, single.active, single.device) == (1, False, False, torch.device("cpu"))


def test_shard_rows_takes_each_ranks_rows():
    x = torch.arange(24).reshape(2, 12)
    assert pm.shard_rows(x, 1, 3, dim=1).tolist() == [[4, 5, 6, 7], [16, 17, 18, 19]]
    assert pm.shard_rows(x, 0, 2).tolist() == [list(range(12))]
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_rows(x, 0, 5, dim=1)


def test_padded_evaluator_on_two_ranks_gives_world_one_bits(cases):
    _, ranks = cases
    cfg = NET_PRESETS["tiny3"]
    assert cfg.compute_dtype == torch.bfloat16
    envs = _random_envs(cfg, 16, seed=13)
    evaluate = torch_agent.make_net_evaluate(cfg, torch_engine(cfg.n, half_komi=cfg.half_komi), device="cpu")
    want = [x.numpy() for x in evaluate(torch_agent.new_agent(cfg, seed=12, device="cpu"), envs)]
    for r in ranks:
        for name, got, w in zip(("logits", "value", "variance"), r["evaluate"], want):
            assert got.tobytes() == w.tobytes(), f"rank {r['rank']} {name}"


def test_at_global_shape_places_rows_at_their_offset():
    seen = []

    def fn(x, scale):
        seen.append(x.clone())
        return x * scale, x.sum(-1)

    world = pm.World(rank=1, size=3)
    x = torch.arange(1, 9, dtype=torch.float32).reshape(2, 4)
    out, total = world.at_global_shape(fn)(x, 2.0)
    (full,) = seen
    assert full.shape == (6, 4)
    assert torch.equal(full[2:4], x) and not full[:2].any() and not full[4:].any()
    assert torch.equal(out, 2 * x) and torch.equal(total, x.sum(-1))
    assert pm.World().at_global_shape(fn) is fn


def test_padded_evaluator_hashes_only_real_rows(monkeypatch):
    cfg = NET_PRESETS["tiny3"]
    eng = torch_engine(cfg.n, half_komi=cfg.half_komi)
    envs = _random_envs(cfg, 8, seed=14)
    bundle = torch_agent.new_agent(cfg, seed=15, device="cpu")
    hashed, net_rows = [], []
    hash_indices, apply_folded = torch_agent.hash_indices, torch_agent.apply_folded
    monkeypatch.setattr(torch_agent, "hash_indices", lambda c, b, p: hashed.append(p.clone()) or hash_indices(c, b, p))
    monkeypatch.setattr(torch_agent, "apply_folded",
                        lambda c, w, p, **k: net_rows.append(p.shape[0]) or apply_folded(c, w, p, **k))
    whole = torch_agent.make_net_evaluate(cfg, eng, device="cpu")(bundle, envs)
    rows = envs.map(lambda x: x[4:])
    padded = torch_agent.make_net_evaluate(cfg, eng, device="cpu", world=pm.World(rank=1, size=2))(bundle, rows)
    assert net_rows == [8, 8]
    assert [h.shape[0] for h in hashed] == [8, 4]
    assert torch.equal(hashed[1], hashed[0][4:])
    for a, b in zip(padded, whole):
        assert torch.equal(a, b[4:])
