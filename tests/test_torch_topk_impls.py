"""The search's choice of top-k in the port (``search/core.py`` ``make_topk``,
``TAKZERO_TOPK``) against the JAX package's.

* ``grouped`` (``ops/topk.py`` ``exact_top_k_unsorted_grouped``) and
  ``lax`` (``ops/topk.py`` ``lax_top_k``) against JAX's grouped top-k and
  ``jax.lax.top_k`` on the modes of ``tests/test_pallas.py``: values bit
  for bit and indices exactly on every row.  ``torch.topk`` documents no
  order among equal values; ``lax_top_k`` runs it on keys that cannot
  tie, so the port's order is ``lax.top_k``'s even on tied rows;
* ``make_topk``'s names and the variable;
* JAX's ``test_search_with_unsorted_topk_matches_lax_semantics``, ported:
  every impl gives the port's search the per-action root statistics it
  gives under ``lax``;
* the port's trees under ``lax`` and ``grouped`` against JAX's trees built
  with the same ``topk=`` (sorted slot layouts), for ``simulate``,
  ``simulate_batch`` and one serve chunk;
* a selection tie among children of equal prior goes to the lower slot in
  both packages, so under two impls (two slot orders) the per-action
  result splits at the same points in JAX as in the port;
* the Gumbel move of ``chip_smoke.py`` phase 18b, at a small size: each
  impl given the same noise per action gives the same actions and
  per-action root visits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.ops.topk import exact_top_k_unsorted_grouped as jax_grouped
from takzero_tpu.search import agents as jax_agents
from takzero_tpu.search import core as jax_core
from takzero_tpu.search import serve as jax_serve
from takzero_tpu.search import tree as jax_tree
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import ptn_to_action
from takzero_torch.ops import topk
from takzero_torch.search import agents as torch_agents
from takzero_torch.search import core as torch_core
from takzero_torch.search import serve as torch_serve
from takzero_torch.search import tree as torch_tree
from takzero_torch.tak import engine as torch_engine

from torch_parity import assert_tree_equal, state_to_torch

torch.set_num_threads(2)

NEG = -3.0e38


def _rows(mode: str, a: int, rng) -> np.ndarray:
    """JAX's modes (``tests/test_pallas.py:217``), plus +-0.0 and +-inf."""
    if mode == "ties":
        return rng.integers(0, 4, (3, a)).astype(np.float32)
    if mode == "masked":
        x = np.full((3, a), NEG, np.float32)
        for i in range(3):
            j = rng.choice(a, 20, replace=False)
            x[i, j] = rng.standard_normal(20).astype(np.float32)
        return x
    if mode == "signed":
        x = rng.choice(np.array([1.0, 0.0, -0.0, -1.0, np.inf, -np.inf], np.float32), (3, a))
        return x.astype(np.float32)
    if mode == "neginf":  # fewer finite entries than k (JAX's test_pallas.py:255)
        x = np.full((3, a), -np.inf, np.float32)
        x[:, 5:9] = rng.standard_normal((3, 4)).astype(np.float32)
        return x
    return rng.standard_normal((3, a)).astype(np.float32)


MODES = ["normal", "ties", "masked", "uneven", "signed", "neginf"]


def _width(mode: str, k: int) -> int:
    return 9036 if mode == "uneven" or k == 256 else 1030


def _assert_bitwise(got, want, what: str) -> None:
    gv, gi = (np.asarray(t) for t in got)
    wv, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32), err_msg=f"{what}: value bits")
    np.testing.assert_array_equal(gi, wi, err_msg=f"{what}: indices")
    assert gi.dtype == np.int32


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("mode", MODES)
def test_grouped_matches_jax(mode, k):
    x = _rows(mode, _width(mode, k), np.random.default_rng(5))
    got = topk.exact_top_k_unsorted_grouped(torch.from_numpy(x), k)
    _assert_bitwise(got, jax_grouped(jnp.asarray(x), k), f"grouped {mode} k={k}")
    assert not np.isnan(got[0].numpy()).any()


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("mode", MODES)
def test_lax_matches_jax_lax_top_k(mode, k):
    x = _rows(mode, _width(mode, k), np.random.default_rng(6))
    got = topk.lax_top_k(torch.from_numpy(x), k)
    _assert_bitwise(got, jax.lax.top_k(jnp.asarray(x), k), f"lax {mode} k={k}")


def test_make_topk_names_and_variable(monkeypatch):
    monkeypatch.delenv("TAKZERO_TOPK", raising=False)
    want = {"pallas": torch_core._kernel_a, "lax": topk.lax_top_k,
            "grouped": topk.exact_top_k_unsorted_grouped, "exact_ref": topk.topk_plain}
    for name, fn in want.items():
        assert torch_core.make_topk(name) is fn
    assert torch_core.make_topk() is torch_core._kernel_a  # auto, no variable: pallas
    # pallas reaches kernel A's wrapper (its plain version on a CPU tensor)
    # through the module's name at each call.
    x = torch.randn(3, 50)
    pallas = torch_core.make_topk("pallas")
    seen = []
    monkeypatch.setattr(torch_core, "exact_top_k_unsorted", lambda x, k: seen.append(k) or topk.topk_plain(x, k))
    for got, ref in zip(pallas(x, 7), topk.exact_top_k_unsorted(x, 7)):
        assert torch.equal(got, ref)
    assert seen == [7]
    assert topk.exact_top_k_unsorted_reference is topk.topk_plain
    for name, fn in want.items():
        monkeypatch.setenv("TAKZERO_TOPK", name)
        assert torch_core.make_topk("auto") is fn
    with pytest.raises(ValueError, match="unknown top-k impl"):
        torch_core.make_topk("radix")
    monkeypatch.setenv("TAKZERO_TOPK", "radix")
    with pytest.raises(ValueError, match="unknown top-k impl"):
        torch_core.make_topk()


def _after_a1_c3():
    """Two copies of 3x3 after ``a1 c3``: action 0 illegal, fewer legal
    moves than 64 child slots (JAX's test_pallas.py:149)."""
    eng = jax_engine(3)
    s = eng.step_jit(eng.step_jit(eng.initial(), ptn_to_action(3, "a1")), ptn_to_action(3, "c3"))
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), s)


def _per_action(tree, a: int):
    """Root child visits and values scattered to actions: the
    slot-permutation-invariant view of a search."""
    act, vis, val = (np.asarray(getattr(tree, f)[:, 0, :]) for f in ("child_action", "child_visit", "child_value"))
    dv, dq = np.zeros((act.shape[0], a), vis.dtype), np.zeros((act.shape[0], a), val.dtype)
    for i in range(act.shape[0]):
        m = act[i] >= 0
        dv[i, act[i, m]], dq[i, act[i, m]] = vis[i, m], val[i, m]
    return dv, dq


@pytest.mark.parametrize("impl", ["exact_ref", "grouped", "pallas"])
def test_search_with_unsorted_topk_matches_lax_semantics(impl):
    eng = torch_engine(3)
    envs = state_to_torch(_after_a1_c3())
    legal = eng.legal_mask(envs)
    assert not legal[0, 0] and int(legal[0].sum()) < 64  # the premise of the test

    def run(name):
        simulate, simulate_batch = torch_core.make_kernels(eng, torch_agents.dummy_evaluator(eng), max_depth=16,
                                                           topk=name)
        tree = simulate(torch_tree.init_tree(eng, envs, max_nodes=16, max_children=64), torch.zeros(2))
        return simulate_batch(tree, torch.zeros(2), 7)

    got, ref = run(impl), run("lax")
    assert bool(got.root_expanded().all())
    np.testing.assert_array_equal(got.node_count.numpy(), ref.node_count.numpy())
    np.testing.assert_array_equal(got.root_visit.numpy(), ref.root_visit.numpy())
    gv, gq = _per_action(got, eng.num_actions)
    rv, rq = _per_action(ref, eng.num_actions)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_allclose(gq, rq, atol=1e-6)


def _simple(n):
    jeng, teng = jax_engine(n), torch_engine(n)
    return jeng, teng, jax_agents.simple_evaluator(jeng), torch_agents.simple_evaluator(teng)


# XLA's CPU ``exp`` and torch's differ in the last bit for about one input
# in ten, so the simple evaluator's priors and the values computed from
# them agree to float32 ulps; every integer array must match exactly.
FLOAT_TOL = {f: 1e-6 for f in ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")}


@pytest.mark.parametrize("impl", ["lax", "grouped"])
@pytest.mark.parametrize("evaluator,children", [("dummy", 48), ("simple", 8)])
def test_trees_under_sorted_impls_match_jax(impl, evaluator, children):
    """simulate and simulate_batch: C=48 holds every 3x3 move, C=8
    truncates (the top-k cut on the simple evaluator's tied logits)."""
    jeng, teng = jax_engine(3), torch_engine(3)
    if evaluator == "dummy":
        jev, tev = jax_agents.dummy_evaluator(jeng), torch_agents.dummy_evaluator(teng)
    else:
        _, _, jev, tev = _simple(3)
    js = _after_a1_c3()
    jsim, jbatch = jax_core.make_kernels(jeng, jev, max_depth=12, topk=impl)
    tsim, tbatch = torch_core.make_kernels(teng, tev, max_depth=12, topk=impl)
    jt = jax_tree.init_tree(jeng, js, max_nodes=48, max_children=children)
    tt = torch_tree.init_tree(teng, state_to_torch(js), max_nodes=48, max_children=children)
    beta = np.array([0.25, 0.0], np.float32)
    jsim, jbatch = jax.jit(jsim), jax.jit(jbatch, static_argnums=2)
    for i in range(4):
        jt, tt = jsim(jt, jnp.asarray(beta)), tsim(tt, torch.from_numpy(beta))
        assert_tree_equal(tt, jt, f"{impl} C={children} sim {i}", FLOAT_TOL)
    jt, tt = jbatch(jt, jnp.asarray(beta), 5), tbatch(tt, torch.from_numpy(beta), 5)
    assert_tree_equal(tt, jt, f"{impl} C={children} simulate_batch", FLOAT_TOL)


def test_serve_chunk_under_lax_matches_jax():
    jeng, teng, jev, tev = _simple(3)
    jsim, _ = jax_core.make_kernels(jeng, jev, max_depth=16, topk="lax")
    jserve = jax_serve.make_serve_chunk(jeng, jev, 15, max_depth=16, topk="lax")
    tsim, _ = torch_core.make_kernels(teng, tev, max_depth=16, topk="lax")
    tserve = torch_serve.make_serve_chunk(teng, tev, 15, max_depth=16, topk="lax")
    js = _after_a1_c3()
    jt = jax_tree.init_tree(jeng, js, 64, 48)
    tt = torch_tree.init_tree(teng, state_to_torch(js), 64, 48)
    jrun = jax.jit(lambda t: jserve(jsim(t, 0.0), 0.0))
    for i in range(2):
        jt, tt = jrun(jt), tserve(tsim(tt, 0.0), 0.0)
        assert_tree_equal(tt, jt, f"serve chunk {i}", FLOAT_TOL)


def _spread_evaluators(a: int):
    """Fixed logits 200 x N(0, 1) (most priors exactly 0.0, as a random
    16x256 net's are) and values +-0.99 by ply, 0 at the root: the visited
    child turns bad, and the search then picks among zero-prior siblings."""
    logits = (200 * np.random.default_rng(0).standard_normal(a)).astype(np.float32)

    def jev(envs):
        v = jnp.where(envs.ply == 1, 0.0, jnp.where(envs.ply % 2 == 0, 0.99, -0.99)).astype(jnp.float32)
        return jnp.broadcast_to(jnp.asarray(logits), (v.shape[0], a)), v, jnp.zeros_like(v)

    def tev(envs):
        v = torch.where(envs.ply == 1, 0.0, torch.where(envs.ply % 2 == 0, 0.99, -0.99)).float()
        return torch.from_numpy(logits).expand(v.shape[0], a), v, torch.zeros_like(v)

    return jev, tev


def test_prior_ties_split_both_packages_alike():
    """Under ``lax`` the root's children sit in logit order, under
    ``exact_ref`` in action order; a pick among equal (zero) priors goes to
    the lower slot, so the two impls part per action after 22-28
    simulations here, in JAX exactly as in the port (each package's tree
    equals the other's under each impl)."""
    jeng, teng = jax_engine(3), torch_engine(3)
    a = jeng.num_actions
    jev, tev = _spread_evaluators(a)
    s = jeng.step_jit(jeng.initial(), ptn_to_action(3, "a1"))
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), s)
    dense = {}
    for impl in ("lax", "exact_ref"):
        jsim = jax.jit(jax_core.make_kernels(jeng, jev, max_depth=16, topk=impl)[0])
        tsim = torch_core.make_kernels(teng, tev, max_depth=16, topk=impl)[0]
        jt = jax_tree.init_tree(jeng, js, 64, 32)
        tt = torch_tree.init_tree(teng, state_to_torch(js), 64, 32)
        for _ in range(24):
            jt, tt = jsim(jt, jnp.zeros(2)), tsim(tt, torch.zeros(2))
        assert_tree_equal(tt, jt, impl, FLOAT_TOL)
        assert (np.asarray(jt.child_prob[:, 0]) == 0.0).sum() > 2  # the premise: zero priors
        dense[impl] = (_per_action(jt, a)[0], _per_action(tt, a)[0])
    jax_split = (dense["lax"][0] != dense["exact_ref"][0]).any()
    port_split = (dense["lax"][1] != dense["exact_ref"][1]).any()
    assert jax_split and port_split


def test_gumbel_move_is_per_action_equal_across_impls(monkeypatch):
    """``chip_smoke.py`` phase 18b at a small size on the CPU, its kernel
    wrappers replaced by counting plain versions: one float32 move under
    each of pallas, lax and grouped from the same weights and openings,
    the same noise per action placed in each impl's slot order."""
    import chip_smoke
    from takzero_torch.models import agent
    from takzero_torch.ops import _build, simhash

    def counting_topk(x, k):
        _build.add_launches({"exact_top_k_unsorted": 1})
        return topk.topk_plain(x, k)

    def counting_simhash(x, m):
        _build.add_launches({"simhash_pack": 1})
        return simhash.simhash_plain(x, m)

    monkeypatch.setattr(torch_core, "exact_top_k_unsorted", counting_topk)
    monkeypatch.setattr(agent, "simhash_pack", counting_simhash)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    out = chip_smoke.run_topk_moves(torch.device("cpu"), filters=16, blocks=6, batch=8, hash_bits=16, sampled=4,
                                    budget=96)
    assert out["impls"]["pallas"]["launches"] == {"exact_top_k_unsorted": 97, "simhash_pack": 97}
    for impl in ("lax", "grouped"):
        assert out["impls"][impl]["launches"] == {"exact_top_k_unsorted": 0, "simhash_pack": 97}
        assert out["impls"][impl]["games_compared"] == 8
