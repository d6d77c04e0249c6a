"""Input planes, the network and the evaluator of the port against JAX.

* ``state_to_planes`` must equal JAX's exactly on random positions at 3x3
  to 6x6, tall stacks included.
* A JAX agent bundle is carried over with ``takzero_torch.bridge`` (BN
  statistics randomised first, so that the fold is exercised); in float32
  ``apply_folded`` and ``make_net_evaluate`` must match JAX to
  ``rtol=atol=1e-4`` (the frameworks sum the convolutions in different
  orders, so only float rounding may differ).
* The SimHash novelty must match exactly with a non-empty seen-set, whose
  bits JAX's ``hash_update`` sets.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.models import agent as jax_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.ops import repr as jax_repr
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak.state import initial_state_batch as jax_initial_batch
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.models import agent as torch_agent
from takzero_torch.models import network as torch_network
from takzero_torch.ops import repr as torch_repr
from takzero_torch.tak import engine as torch_engine

from torch_parity import state_to_torch, tall_states

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _jax_batch_fns(n: int):
    """Jitted batched (legal_mask, step, terminal_kind), compiled once per n."""
    eng = jax_engine(n, half_komi=4)
    return tuple(jax.jit(jax.vmap(f)) for f in (eng.legal_mask, eng.step, eng.terminal_kind))


def _positions(n: int, batch: int, plies: int, seed: int):
    """Random playout positions (JAX states), one snapshot per game."""
    legal, step, kind = _jax_batch_fns(n)
    rng = np.random.default_rng(seed)
    js = jax_initial_batch(n, batch)
    stop = rng.integers(1, plies + 1, size=batch)
    snaps = [None] * batch
    for p in range(plies + 1):
        for i in np.flatnonzero(stop == p):
            snaps[i] = jax.tree.map(lambda x, i=i: np.asarray(x[i]), js)
        mask = np.asarray(legal(js))
        done = np.asarray(kind(js)) != 0
        acts = np.array(
            [0 if d or not m.any() else rng.choice(np.flatnonzero(m)) for m, d in zip(mask, done)],
            np.int32,
        )
        nxt = step(js, jnp.asarray(acts))
        keep = jnp.asarray(done)
        js = jax.tree.map(
            lambda a, b: jnp.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), js, nxt
        )
    return jax.tree.map(lambda *xs: np.stack(xs), *snaps)


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_planes_match_jax(n):
    js = _positions(n, batch=16, plies=40, seed=n)
    jeng, teng = jax_engine(n, half_komi=4), torch_engine(n, half_komi=4)
    want = np.asarray(jax.vmap(lambda s: jax_repr.state_to_planes(jeng, s))(js))
    got = torch_repr.state_to_planes(teng, state_to_torch(js)).numpy()
    assert got.shape == (16, torch_repr.input_channels(n), n, n)
    assert torch_repr.input_size(n) == jax_repr.input_size(n)
    np.testing.assert_array_equal(got, want)


def test_planes_match_jax_tall_stacks():
    js = tall_states(6, 8, seed=3)
    jeng, teng = jax_engine(6, half_komi=4), torch_engine(6, half_komi=4)
    want = np.asarray(jax.vmap(lambda s: jax_repr.state_to_planes(jeng, s))(js))
    got = torch_repr.state_to_planes(teng, state_to_torch(js)).numpy()
    np.testing.assert_array_equal(got, want)


_CONFIGS = {
    "tiny3": dict(n=3, half_komi=0, filters=16, blocks=2, hash_bits=12),
    "small4": dict(n=4, half_komi=4, filters=24, blocks=3, hash_bits=16),
}


def _bundle(name: str, dtype: str, seed: int = 0):
    """(JAX cfg, JAX bundle with randomised BN state, port cfg, port agent)."""
    kw = _CONFIGS[name]
    jcfg = jax_network.NetConfig(novelty="simhash", compute_dtype=getattr(jnp, dtype), **kw)
    tcfg = torch_network.NetConfig(novelty="simhash", compute_dtype=getattr(torch, dtype), **kw)
    bundle = jax_agent.new_agent(jcfg, seed=seed)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        leaf = jax.tree_util.keystr(path)
        x = np.array(x)
        if "'var'" in leaf:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if any(s in leaf for s in ("'mean'", "'scale'", "'bias'")):
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x

    bundle["params"] = jax.tree_util.tree_map_with_path(perturb, bundle["params"])
    bundle["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, bundle["batch_stats"])
    bundle = jax.tree.map(jnp.asarray, bundle)
    agent = from_jax_bundle(jax.tree.map(np.asarray, bundle), tcfg, device="cpu")
    return jcfg, bundle, tcfg, agent


def _planes(cfg, batch: int, seed: int):
    js = _positions(cfg.n, batch, plies=30, seed=seed)
    planes = jax.vmap(lambda s: jax_repr.state_to_planes(jax_engine(cfg.n, cfg.half_komi), s))(js)
    return js, np.array(planes)


@pytest.mark.parametrize("name", ["tiny3", "small4"])
def test_apply_folded_f32_matches_jax(name):
    jcfg, bundle, tcfg, agent = _bundle(name, "float32")
    _, planes = _planes(jcfg, 12, seed=1)
    fw = jax_network.fold_inference_params(jcfg, bundle["params"], bundle["batch_stats"])
    want = jax.jit(lambda p: jax_network.apply_folded(jcfg, fw, p))(jnp.asarray(planes))
    got = torch_network.apply_folded(tcfg, agent["folded"], torch.from_numpy(planes))
    for g, w, what in zip(got, want, ("policy", "value", "ube")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=what)
    # The unfolded eval-mode modules give the same outputs.
    with torch.no_grad():
        eager = agent["net"](torch.from_numpy(planes))
    for g, e, what in zip(got, eager, ("policy", "value", "ube")):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-4, atol=1e-4, err_msg=what)


def test_apply_folded_bf16_close_to_jax():
    """Both packages round each convolution's operands to bf16, multiply and
    accumulate them in float32, add the f32 bias to that float32 result and
    round the activation to bf16 once per layer.  Only the float32
    summation order may differ, so the outputs are held to 1e-6 and the
    policy argmax must agree on every position."""
    jcfg, bundle, tcfg, agent = _bundle("tiny3", "bfloat16")
    _, planes = _planes(jcfg, 32, seed=2)
    fw = jax_network.fold_inference_params(jcfg, bundle["params"], bundle["batch_stats"])
    want = jax.jit(lambda p: jax_network.apply_folded(jcfg, fw, p))(jnp.asarray(planes))
    got = torch_network.apply_folded(tcfg, agent["folded"], torch.from_numpy(planes))
    for g, w, what in zip(got, want, ("policy", "value", "ube")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=what)
    same = (got[0].argmax(-1).numpy() == np.asarray(want[0]).argmax(-1)).mean()
    assert same == 1.0, same


@pytest.mark.parametrize("name", ["tiny3", "small4"])
def test_net_evaluate_and_novelty_match_jax(name):
    jcfg, bundle, tcfg, _ = _bundle(name, "float32", seed=4)
    js, planes = _planes(jcfg, 24, seed=5)
    # Mark the first half of the positions as seen, on the JAX side.
    bundle = jax_agent.hash_update(jcfg, bundle, jnp.asarray(planes[:12]))
    agent = from_jax_bundle(jax.tree.map(np.asarray, bundle), tcfg, device="cpu")
    assert int(np.count_nonzero(np.asarray(bundle["hash_bits"]))) > 0

    # Hash indices agree bit for bit (no dot product is near zero here).
    x = planes.copy()
    x[:, jax_repr.input_channels(jcfg.n) - 2] = 0.0
    dots = x.reshape(len(x), -1).astype(np.float64) @ np.asarray(bundle["hash_matrix"], np.float64)
    assert np.abs(dots).min() > 1e-4
    want_idx = np.asarray(jax_agent.simhash_indices(jcfg, bundle["hash_matrix"], jnp.asarray(planes)))
    got_idx = torch_agent.simhash_indices(tcfg, agent["hash_matrix"], torch.from_numpy(planes))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx.astype(np.int64))

    want_nov = np.asarray(jax_agent.hash_novelty(jcfg, bundle, jnp.asarray(planes)))
    got_nov = torch_agent.hash_novelty(tcfg, agent, torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got_nov, want_nov)
    assert (got_nov[:12] == 0).all() and (got_nov[12:] > 0).any()

    jeval = jax.jit(jax_agent.make_net_evaluate(jcfg, jax_engine(jcfg.n, jcfg.half_komi)))
    teval = torch_agent.make_net_evaluate(tcfg, torch_engine(tcfg.n, tcfg.half_komi), device="cpu")
    want = jeval(bundle, js)
    got = teval(agent, state_to_torch(js))
    for g, w, what in zip(got, want, ("policy", "value", "variance")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=what)


def test_novelty_none_and_fresh_agent():
    cfg = dataclasses.replace(
        torch_network.NetConfig(**_CONFIGS["tiny3"]), novelty="none", compute_dtype=torch.float32
    )
    agent = torch_agent.new_agent(cfg, seed=1, device="cpu")
    assert "hash_bits" not in agent
    teng = torch_engine(3)
    envs = teng.initial(5)
    logits, value, var = torch_agent.make_net_evaluate(cfg, teng, device="cpu")(agent, envs)
    assert logits.shape == (5, cfg.num_actions) and value.shape == var.shape == (5,)
    _, _, ube = torch_network.apply_folded(cfg, agent["folded"], torch_repr.state_to_planes(teng, envs))
    torch.testing.assert_close(var, torch.exp(ube).clamp(0.0, 4.0))
    # A fresh simhash agent sees nothing yet: novelty is the maximum.
    cfg_h = dataclasses.replace(cfg, novelty="simhash")
    agent_h = torch_agent.new_agent(cfg_h, seed=1, device="cpu")
    nov = torch_agent.hash_novelty(cfg_h, agent_h, torch_repr.state_to_planes(teng, envs))
    assert (nov == torch_network.MAXIMUM_VARIANCE).all()
