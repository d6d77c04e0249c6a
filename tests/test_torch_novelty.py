"""The port's novelty estimators (LCG hash, RND conv tower and MLP, the
value-head ensemble) against the JAX package's, on the CPU.

Bundles come from JAX's ``new_agent`` at the sizes of JAX's own tests
(``tests/test_network.py``'s ``TINY``) and cross through
``takzero_torch.bridge``; positions are random openings, or random-game
targets read by JAX's ``make_batch_native``.

* ``lcghash_indices``: equal to JAX's bit for bit at n = 3 and 4 and 20,
  24 and 32 bits, with scales that have negative entries over zero planes
  (-0.0 bit patterns); the port's closed form equals a serial LCG fold.
* ``rnd_raw`` (tower and MLP), ``rnd_novelty`` and
  ``rnd_update_normalization``: float32 within rtol 1e-5; bf16 within
  rtol 1e-2 (only the order of the float32 sums inside a layer differs,
  and a sum within rounding of a bf16 boundary rounds the other way).
* ``make_net_evaluate`` for rnd, rnd_mlp, lcghash and ensemble: logits,
  value and variance within 1e-4 in float32 (as
  ``tests/test_torch_repr_network.py``); lcghash's novelty exactly (an
  unseen position's variance is 4 on both sides, a seen one's is exp(ube)
  on both).
* Two train steps at ``tiny3_rnd`` against ``make_train_step``: in
  float32 the metrics (``loss_rnd`` included) and the running statistics
  within 1e-5, the net's and the predictor's weights within 2e-6 except
  entries whose JAX gradient falls below 1e-6 at a step (Adam's first
  steps move an entry by lr * sign(g)); in bf16 the metrics and running
  statistics within 5e-2 (as ``tests/test_torch_learner.py``).  The
  target stays bit for bit the same.
* A bridge and checkpoint round trip for each variant, and the poller's
  reload of ``rnd_min``/``rnd_max``.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.data import native_loader as jax_loader
from takzero_tpu.models import agent as jax_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.train import learner as jax_learner
from takzero_tpu.train.data import random_pretraining_targets as jax_random_targets
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.models import agent as torch_agent
from takzero_torch.models import network as torch_network
from takzero_torch.ops.repr import state_to_planes
from takzero_torch.search.openings import make_new_opening
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak import engine as torch_engine
from takzero_torch.train import learner as torch_learner
from takzero_torch.utils import ckpt

from torch_parity import state_to_jax, state_to_torch

torch.set_num_threads(2)

TINY = dict(filters=16, blocks=2, hash_bits=12, rnd_filters=8, rnd_blocks=1)
VARIANTS = {
    "rnd": dict(novelty="rnd"),
    "rnd_mlp": dict(novelty="rnd", rnd_mlp=True),
    "lcghash": dict(novelty="lcghash", hash_bits=20),
    "ensemble": dict(novelty="ensemble", ensemble_size=4),
}


def _configs(n: int = 3, dtype: str = "float32", **kw):
    kw = {**TINY, **kw}
    return (jax_network.NetConfig(n=n, half_komi=0, compute_dtype=getattr(jnp, dtype), **kw),
            torch_network.NetConfig(n=n, half_komi=0, compute_dtype=getattr(torch, dtype), **kw))


def _perturbed(bundle, seed: int):
    """BatchNorm statistics, scales and biases moved off their identity
    initialisation, so that the fold and the running statistics count."""
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
    for key in ("params", "batch_stats", "rnd_params", "rnd_batch_stats", "ensemble_params"):
        if key in out:
            out[key] = jax.tree_util.tree_map_with_path(perturb, out[key])
    return jax.tree.map(jnp.asarray, out)


def _bridge(jbundle, tcfg):
    return from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")


def _planes(n: int, batch: int, seed: int, plies: int = 6):
    """Random openings, made on the port's engine (JAX's eager opening
    compiles for seconds per shape; the planes of the two packages are
    equal, ``tests/test_torch_repr_network.py``): (JAX states, JAX planes,
    torch planes)."""
    eng = torch_engine(n)
    gen = torch.Generator().manual_seed(seed)
    sym, pair = torch.randint(0, 8, (batch,), generator=gen), torch.randint(0, 2, (batch,), generator=gen)
    envs = make_new_opening(eng, random_steps=plies)(sym, pair, gumbel_noise(gen, (plies, batch, eng.num_actions)))
    planes = state_to_planes(eng, envs)
    return state_to_jax(envs), jnp.asarray(planes.numpy()), planes


# ---------------------------------------------------------------------------
# LCG hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("bits", [20, 24, 32])
def test_lcghash_indices_equal_jax(n, bits):
    jcfg, tcfg = _configs(n, novelty="lcghash", hash_bits=bits)
    jbundle = jax_agent.new_agent(jcfg, seed=bits)
    tbundle = _bridge(jbundle, tcfg)
    _, jplanes, tplanes = _planes(n, 64, seed=n * bits)
    scale = tbundle["hash_scale"]
    assert (scale < 0).any()
    # Zero planes times negative scales: -0.0, whose bits are 0x80000000.
    scaled = torch_agent._without_side_to_move(tcfg, tplanes) * scale[None]
    assert ((scaled == 0) & torch.signbit(scaled)).any()
    want = np.asarray(jax_agent.lcghash_indices(jcfg, jbundle["hash_scale"], jplanes)).astype(np.int64)
    got = torch_agent.lcghash_indices(tcfg, scale, tplanes)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) > 32  # the positions hash apart
    # The hash-log helpers agree with JAX's on the same bundle.
    jidx, jfresh = jax_agent.hash_indices_fresh(jcfg, jbundle, jplanes)
    tidx, tfresh = torch_agent.hash_indices_fresh(tcfg, tbundle, tplanes)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx).astype(np.int64))
    np.testing.assert_array_equal(tfresh.numpy(), np.asarray(jfresh))
    jbundle = jax_agent.hash_update(jcfg, jbundle, jplanes)
    torch_agent.hash_update(tcfg, tbundle, tplanes)
    np.testing.assert_array_equal(tbundle["hash_bits"].numpy().view(np.uint32), np.asarray(jbundle["hash_bits"]))


def _serial_fold(words) -> int:
    acc = 0
    for x in words:
        acc = (torch_agent._LCG_A * acc + torch_agent._LCG_C + int(x)) & 0xFFFFFFFF
    return acc


@pytest.mark.parametrize("k", [1, 2, 216, 4096])
def test_lcg_closed_form_equals_serial_fold(k):
    """The closed form against the serial fold (JAX's test_pallas
    counterpart), on the largest words too: K = 4,096 words of 0xFFFFFFFF
    must not overflow the int64 sum."""
    rng = np.random.default_rng(k)
    words = rng.integers(0, 1 << 32, size=(3, k), dtype=np.int64)
    words[0] = 0xFFFFFFFF
    words[1, : k // 2] = 0
    got = torch_agent.lcg_fold(torch.from_numpy(words))
    assert got.tolist() == [_serial_fold(row) for row in words]


def test_lcghash_indices_are_the_serial_fold_of_the_scaled_planes():
    jcfg, tcfg = _configs(4, novelty="lcghash", hash_bits=32)
    tbundle = _bridge(jax_agent.new_agent(jcfg, seed=3), tcfg)
    _, _, planes = _planes(4, 8, seed=4)
    x = torch_agent._without_side_to_move(tcfg, planes) * tbundle["hash_scale"][None]
    words = x.reshape(8, -1).numpy().view(np.uint32)
    got = torch_agent.lcghash_indices(tcfg, tbundle["hash_scale"], planes)
    assert got.tolist() == [_serial_fold(row) for row in words]
    short = torch_agent.lcghash_indices(dataclasses.replace(tcfg, hash_bits=24), tbundle["hash_scale"], planes)
    assert short.tolist() == [v >> 8 for v in got.tolist()]


# ---------------------------------------------------------------------------
# RND
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp", [False, True], ids=["tower", "mlp"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_rnd_error_novelty_and_normalization_match_jax(mlp, dtype, tol):
    jcfg, tcfg = _configs(4, dtype, novelty="rnd", rnd_mlp=mlp)
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=5), seed=5)
    tbundle = _bridge(jbundle, tcfg)
    _, jearly, tearly = _planes(4, 32, seed=6, plies=2)
    _, jlate, tlate = _planes(4, 32, seed=7, plies=20)
    want = np.asarray(jax_agent.rnd_raw(jcfg, jbundle, jlate))
    np.testing.assert_allclose(torch_agent.rnd_raw(tcfg, tbundle, tlate).numpy(), want, rtol=tol)
    jbundle = jax_agent.rnd_update_normalization(jcfg, jbundle, jearly, jlate)
    assert torch_agent.rnd_update_normalization(tcfg, tbundle, tearly, tlate) is tbundle
    for key in ("rnd_min", "rnd_max"):
        assert tbundle[key].shape == ()
        np.testing.assert_allclose(float(tbundle[key]), float(jbundle[key]), rtol=tol, err_msg=key)
    assert float(tbundle["rnd_min"]) < float(tbundle["rnd_max"])
    # Within the bounds' range and clipped outside it: novelty in [0, 4].
    planes = torch.cat([tearly, tlate])
    got = torch_agent.rnd_novelty(tcfg, tbundle, planes).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_agent.rnd_novelty(jcfg, jbundle, jnp.asarray(planes.numpy()))), rtol=tol, atol=4 * tol)
    assert got.min() == 0.0 and got.max() == 4.0 and ((got > 0) & (got < 4)).any()


def test_rnd_pair_train_mode_leaves_the_target_in_eval():
    cfg = torch_network.NetConfig(n=3, filters=8, blocks=1, novelty="rnd", rnd_filters=8, rnd_blocks=1)
    pair = torch_network.init_rnd(cfg, seed=0).train()
    assert pair.predictor.training and not pair.target.training
    assert all(not p.requires_grad for p in pair.target.parameters())
    # Predictor and target are drawn apart.
    assert not torch.equal(pair.predictor.stem.conv.weight, pair.target.stem.conv.weight)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_net_evaluate_matches_jax(variant):
    jcfg, tcfg = _configs(3, **VARIANTS[variant])
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=8), seed=8)
    envs, jplanes, tplanes = _planes(3, 24, seed=9)
    if variant == "lcghash":  # half the positions seen
        jbundle = jax_agent.hash_update(jcfg, jbundle, jplanes[:12])
    if variant.startswith("rnd"):
        early, late = _planes(3, 16, seed=10, plies=1)[1], _planes(3, 16, seed=11, plies=8)[1]
        jbundle = jax_agent.rnd_update_normalization(jcfg, jbundle, early, late)
    tbundle = _bridge(jbundle, tcfg)
    evaluate = jax_agent.make_net_evaluate(jcfg, jax_engine(3))
    # lcghash reads the planes' bits: JAX's jitted planes are 1 ulp off its
    # eager ones in the reserve planes of some positions (XLA multiplies by
    # the reciprocal), and the seen bits above came from eager planes, as
    # the port's (exact) planes are.  So JAX evaluates eagerly there.
    want = (evaluate if variant == "lcghash" else jax.jit(evaluate))(jbundle, envs)
    got = torch_agent.make_net_evaluate(tcfg, torch_engine(3), device="cpu")(tbundle, state_to_torch(envs))
    for g, w, what in zip(got, want, ("logits", "value", "variance")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=what)
        if variant == "lcghash" and what == "variance":  # the hash novelty: exact
            np.testing.assert_array_equal(g.numpy() == 4, w == 4)
            assert (w[:12] < 4).all() and (w[12:] == 4).all()
    var = got[2].numpy()
    assert (var >= 0).all() and (var <= 4).all()
    if variant == "ensemble":
        heads = tbundle["ensemble"](torch_network.apply_folded(tcfg, tbundle["folded"], tplanes, with_core=True)[3])
        assert heads.shape == (24, 4) and (heads.var(-1, correction=0) > 0).all()


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _batches(count: int, size: int, seed: int):
    eng = jax_engine(3, half_komi=0)
    rng = np.random.default_rng(seed)
    lines = [t.to_line() for t in jax_random_targets(eng, count * size, rng)]
    out = []
    for i in range(count):
        jb = jax_loader.make_batch_native(eng, "\n".join(lines[i * size : (i + 1) * size]) + "\n", rng)
        out.append((jb, torch_learner.Batch(*(torch.from_numpy(np.array(x)) for x in jb))))
    return out


def _torch_layout(jbundle, tcfg, **trees):
    """JAX trees (weights, statistics or gradients) in the torch layout:
    (net state dict, RND pair state dict), through the bridge."""
    b = dict(jax.tree.map(np.asarray, jbundle))
    b.update(jax.tree.map(np.asarray, trees))
    out = from_jax_bundle(b, tcfg, device="cpu")
    return out["net"].state_dict(), out["rnd"].state_dict()


@functools.partial(jax.jit, static_argnums=(0, 4))
def _jax_grads(jcfg, trainable, stats, jb, train_ube):
    """Gradients of JAX's RND train loss w.r.t. (params, rnd_params)."""

    def full(trainable):
        params, rnd_params = trainable
        loss, _ = jax_learner.loss_fn(jcfg, params, stats[0], jb, train_ube)
        err, _ = jax_network.RndPair(jcfg).apply(
            {"params": rnd_params, "batch_stats": stats[1]}, jb.planes, train=True, mutable=["batch_stats"])
        return loss + jnp.mean(err)

    return jax.grad(full)(trainable)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_rnd_train_steps_match_jax(dtype):
    jcfg = dataclasses.replace(JAX_PRESETS["tiny3_rnd"], compute_dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(NET_PRESETS["tiny3_rnd"], compute_dtype=getattr(torch, dtype))
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=12), seed=12)
    tbundle = _bridge(jbundle, tcfg)
    target0 = {k: v.clone() for k, v in tbundle["rnd"].target.state_dict().items()}
    tx = jax_learner.make_optimizer()
    jstep = jax.jit(jax_learner.make_train_step(jcfg, tx), static_argnames=("train_ube",))
    opt_state = jax_learner.init_opt(jcfg, tx, jbundle)
    opt = torch_learner.make_optimizer(tbundle)
    assert len(opt.param_groups[0]["params"]) == (len(list(tbundle["net"].parameters()))
                                                  + len(list(tbundle["rnd"].predictor.parameters())))
    tstep = torch_learner.make_train_step(tcfg)
    tol = 1e-5 if dtype == "float32" else 5e-2
    small = None
    for (jb, tb), train_ube in zip(_batches(2, 32, seed=13), (False, True)):
        if dtype == "float32":
            g_net, g_rnd = _jax_grads(jcfg, (jbundle["params"], jbundle["rnd_params"]),
                                      (jbundle["batch_stats"], jbundle["rnd_batch_stats"]), jb, train_ube)
            g = _torch_layout(jbundle, tcfg, params=g_net, rnd_params=g_rnd)
            tiny = [{k: v.abs() < 1e-6 for k, v in sd.items()} for sd in g]
            small = tiny if small is None else [{k: a[k] | b[k] for k in a} for a, b in zip(small, tiny)]
        jbundle, opt_state, jm = jstep(jbundle, opt_state, jb, train_ube=train_ube)
        tm = tstep(tbundle, opt, tb, train_ube)
        assert set(tm) == set(jm) and "loss_rnd" in tm
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
        assert not tbundle["rnd"].training and not tbundle["rnd"].predictor.training
    want = _torch_layout(jbundle, tcfg)
    got = (tbundle["net"].state_dict(), tbundle["rnd"].state_dict())
    for i, (w_sd, g_sd) in enumerate(zip(want, got)):
        for name, w in w_sd.items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g_sd[name].numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=name)
            elif dtype == "float32":
                off = (g_sd[name] - w).abs() > 2e-6
                assert not (off & ~small[i][name]).any(), (name, float((g_sd[name] - w).abs().max()))
    # The predictor trained; the target is bit for bit the same, statistics included.
    assert not torch.equal(got[1]["predictor.stem.conv.weight"], target0["stem.conv.weight"])
    for k, v in tbundle["rnd"].target.state_dict().items():
        assert torch.equal(v, target0[k]), k
    for k, v in want[1].items():
        if k.startswith("target."):
            assert torch.equal(v, target0[k[len("target."):]]), k
    assert all(torch.isfinite(p).all() for p in tbundle["rnd"].parameters())


# ---------------------------------------------------------------------------
# Bridge, checkpoints, poller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_and_checkpoint_round_trip(variant, tmp_path):
    jcfg, tcfg = _configs(3, **VARIANTS[variant])
    jbundle = _perturbed(jax_agent.new_agent(jcfg, seed=14), seed=14)
    _, jplanes, tplanes = _planes(3, 8, seed=15)
    if variant == "lcghash":
        jbundle = jax_agent.hash_update(jcfg, jbundle, jplanes)
    if variant.startswith("rnd"):
        jbundle = jax_agent.rnd_update_normalization(jcfg, jbundle, jplanes, jplanes)
    src = _bridge(jbundle, tcfg)
    # The bridge carries every novelty tensor over.
    if variant == "lcghash":
        np.testing.assert_array_equal(src["hash_scale"].numpy(), np.asarray(jbundle["hash_scale"]))
        np.testing.assert_array_equal(src["hash_bits"].numpy().view(np.uint32), np.asarray(jbundle["hash_bits"]))
    if variant.startswith("rnd"):
        for key in ("rnd_min", "rnd_max"):
            assert float(src[key]) == float(jbundle[key])
    dst = torch_agent.new_agent(tcfg, seed=99, device="cpu")
    path = ckpt.save_checkpoint(tmp_path, "model_0000001.ckpt", src)
    state = ckpt.read_checkpoint(path)
    assert set(state) == {"net", *(k for k in ("rnd", "ensemble") if k in src),
                          *(k for k in ckpt.TENSORS if k in src)}
    ckpt.load_checkpoint(path, dst)
    a, b = ckpt._bundle_tensors(src), ckpt._bundle_tensors(dst)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    evaluate = torch_agent.make_net_evaluate(tcfg, torch_engine(3), device="cpu")
    envs = state_to_torch(_planes(3, 8, seed=16)[0])
    for x, y in zip(evaluate(src, envs), evaluate(dst, envs)):
        assert torch.equal(x, y)
    # A file of another novelty names what it misses and what it has extra.
    other = torch_agent.new_agent(dataclasses.replace(tcfg, novelty="none"), seed=0, device="cpu")
    if variant != "lcghash":
        with pytest.raises(ckpt.CheckpointMismatch, match="unexpected"):
            ckpt.load_checkpoint(path, other)
    plain = ckpt.save_checkpoint(tmp_path, "plain.ckpt", other)
    with pytest.raises(ckpt.CheckpointMismatch, match="missing .*(rnd|ensemble|hash_scale)"):
        ckpt.load_checkpoint(plain, dst)


def test_poller_reloads_the_rnd_bounds_and_weights(tmp_path):
    cfg = torch_network.NetConfig(n=3, half_komi=0, filters=8, blocks=1, novelty="rnd", rnd_filters=8,
                                  rnd_blocks=1)
    learner = torch_agent.new_agent(cfg, seed=1, device="cpu")
    actor = torch_agent.new_agent(cfg, seed=2, device="cpu")
    _, _, early = _planes(3, 8, seed=17, plies=1)
    _, _, late = _planes(3, 8, seed=18, plies=8)
    torch_agent.rnd_update_normalization(cfg, learner, early, late)
    ckpt.save_checkpoint(tmp_path, "model_latest.ckpt", ckpt.strip_hash_bits(learner))
    assert "rnd" in ckpt.read_checkpoint(tmp_path / "model_latest.ckpt")
    poller = ckpt.LatestPoller(tmp_path)
    assert poller.reload_if_changed(actor, logging.getLogger("t"))[1] and poller.reloads == 1
    for key in ("rnd_min", "rnd_max"):
        assert torch.equal(actor[key], learner[key]) and float(actor[key]) != float(key == "rnd_max")
    for x, y in zip(actor["rnd"].state_dict().values(), learner["rnd"].state_dict().values()):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(torch_agent.rnd_novelty(cfg, actor, late).numpy(),
                                  torch_agent.rnd_novelty(cfg, learner, late).numpy())
