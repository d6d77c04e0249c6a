"""The port's serve-path search against the JAX package's.

``make_serve_chunk`` (the wavefront), ``simulate_batch``,
``descend_host``/``descend_device`` and openings with random plies run on
the same inputs in both packages.  Every integer array must equal JAX's
exactly outside the scratch row (the last pool row, a write sink whose
content is garbage by design, where duplicate stores land in an order
neither package fixes); the float arrays are held to the tolerance each
test states.

``TAKZERO_TOPK=exact_ref`` makes JAX select children as the TPU kernel does
(ties to the lower index, ascending index order), the port's contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.models.agent import make_net_evaluate as jax_net_evaluate
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.search import agents as jax_agents
from takzero_tpu.search import core as jax_core
from takzero_tpu.search import eval as jax_ev
from takzero_tpu.search import serve as jax_serve
from takzero_tpu.search import tree as jax_tree
from takzero_tpu.search.openings import make_new_opening as jax_opening
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import ptn_to_action
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.search import agents as torch_agents
from takzero_torch.search import core as torch_core
from takzero_torch.search import serve as torch_serve
from takzero_torch.search import tree as torch_tree
from takzero_torch.search.openings import make_new_opening
from takzero_torch.tak import engine as torch_engine

from torch_parity import assert_state_equal, assert_tree_equal, state_to_torch, tree_to_torch

torch.set_num_threads(2)

FLOATS = ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")


def _tol(t: float) -> dict:
    return {f: t for f in FLOATS}


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _roots(n, openings):
    """One JAX root per move list (a batch)."""
    eng = jax_engine(n)
    states = []
    for moves in openings:
        s = eng.initial()
        for mv in moves:
            s = eng.step_jit(s, ptn_to_action(n, mv))
        states.append(s)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _dummy(n):
    jeng, teng = jax_engine(n), torch_engine(n)
    return jeng, teng, jax_agents.dummy_evaluator(jeng), torch_agents.dummy_evaluator(teng)


def _tiny3_bf16():
    """The bridged tiny3 network in its preset's bf16, on both sides."""
    jeng, teng = jax_engine(3), torch_engine(3)
    jbundle = jax_new_agent(JAX_PRESETS["tiny3"], seed=4)
    tagent = from_jax_bundle(jax.tree.map(np.asarray, jbundle), NET_PRESETS["tiny3"], device="cpu")
    jnet = jax_net_evaluate(JAX_PRESETS["tiny3"], jeng)
    tnet = make_net_evaluate(NET_PRESETS["tiny3"], teng, device="cpu")
    return jeng, teng, (lambda e: jnet(jbundle, e)), (lambda e: tnet(tagent, e))


def _serve_pair(jeng, teng, jev, tev, k, max_depth, beta):
    """(JAX run, port run): one plain simulate, then one serve chunk."""
    jsim, _ = jax_core.make_kernels(jeng, jev, max_depth=max_depth)
    jserve = jax_serve.make_serve_chunk(jeng, jev, k, max_depth=max_depth)
    tsim, _ = torch_core.make_kernels(teng, tev, max_depth=max_depth)
    tserve = torch_serve.make_serve_chunk(teng, tev, k, max_depth=max_depth)
    jrun = jax.jit(lambda t: jserve(jsim(t, beta), beta))
    return jrun, lambda t: tserve(tsim(t, beta), beta)


# (board, openings, K, pool rows, child slots, chunks, evaluator, tolerance).
# The dummy evaluator's values are 0 and its logits all equal, so every
# float is exact there; 1e-6 is the stated bound.  The bf16 network's
# outputs agree with JAX's to float32 rounding (the two sum the
# convolutions in other orders), so its values are held to 1e-5.  The 3x3
# pool of 32 rows fills in the second chunk (the overflow path).
SERVE_CASES = {
    "dummy-3x3-B2": (3, [["a3", "c1"], ["b2"]], 15, 32, 48, 3, "dummy", 1e-6),
    "dummy-5x5": (5, [["a5", "e1"]], 15, 64, 64, 3, "dummy", 1e-6),
    "tiny3-bf16": (3, [["a3", "c1"], ["b2", "a1"]], 15, 96, 48, 3, "tiny3", 1e-5),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_chunk_matches_jax(case):
    n, openings, k, nodes, children, chunks, which, tol = SERVE_CASES[case]
    jeng, teng, jev, tev = _dummy(n) if which == "dummy" else _tiny3_bf16()
    jrun, trun = _serve_pair(jeng, teng, jev, tev, k, 16, 0.0)
    js = _roots(n, openings)
    jt = jax_tree.init_tree(jeng, js, nodes, children)
    tt = torch_tree.init_tree(teng, state_to_torch(js), nodes, children)
    for i in range(chunks):
        jt, tt = jrun(jt), trun(tt)
        assert_tree_equal(tt, jt, f"{case} chunk {i}", _tol(tol))
    assert (tt.root_visit.numpy() == chunks * (k + 1)).all()


def test_serve_chunk_on_unexpanded_root_is_noop():
    """A lane whose root was never expanded is left as it was (JAX's
    ``test_unexpanded_root_is_noop``), in both packages alike."""
    jeng, teng, jev, tev = _dummy(3)
    jserve = jax.jit(jax_serve.make_serve_chunk(jeng, jev, 7, max_depth=16))
    tserve = torch_serve.make_serve_chunk(teng, tev, 7, max_depth=16)
    js = _roots(3, [["a3", "c1"], ["a3", "c1"]])
    jt0 = jax_tree.init_tree(jeng, js, 32, 48)
    tt0 = torch_tree.init_tree(teng, state_to_torch(js), 32, 48)
    before = tree_to_torch(jt0)
    jt = jserve(jt0, jnp.zeros(2))
    tt = tserve(tt0, 0.0)
    assert_tree_equal(tt, jt, "unexpanded root")
    for name in ("root_visit", "node_count", "overflow"):
        assert torch.equal(getattr(tt, name), getattr(before, name)), name
    for name in ("child_action", "child_visit"):
        assert torch.equal(getattr(tt, name)[:, :-1], getattr(before, name)[:, :-1]), name


TINUE = ["a3", "c1", "c2", "c3", "b3", "c3-"]


def _prove_tinue(jrun, trun, k_chunks=24):
    """Chunks on the 3x3 tinue until the root is a proven win, trees
    compared after each; returns the port's tree."""
    js = _roots(3, [TINUE])
    jt = jax_tree.init_tree(jax_engine(3), js, 1600, 64)
    tt = torch_tree.init_tree(torch_engine(3), state_to_torch(js), 1600, 64)
    for i in range(k_chunks):
        jt, tt = jrun(jt), trun(tt)
        assert_tree_equal(tt, jt, f"tinue chunk {i}", _tol(1e-6))
        if int(tt.root_flag[0]) == jax_ev.WIN:
            break
    assert int(tt.root_flag[0]) == jax_ev.WIN
    acts, flags = tt.child_action[0, 0].numpy(), tt.child_flag[0, 0].numpy()
    assert ptn_to_action(3, "b1") in {int(a) for a, f in zip(acts, flags) if a >= 0 and f == jax_ev.LOSS}
    return tt


def test_serve_chunk_proves_tinue_as_jax():
    jeng, teng, jev, tev = _dummy(3)
    jrun, trun = _serve_pair(jeng, teng, jev, tev, 63, 32, 1.0)
    _prove_tinue(jrun, trun)


# ---------------------------------------------------------------------------
# simulate_batch: the cases of tests/test_simulate_batch.py.
# ---------------------------------------------------------------------------

# (openings, K, pool rows, child slots, beta, chunks, max_depth)
BATCH_CASES = {
    "accounting-B2": ([["a3", "c1"], ["a3", "c1"]], 15, 32, 48, 0.0, 1, 16),
    "spread": ([["a3", "c1"]], 31, 48, 48, 0.0, 1, 16),
    "two-chunks-B2": ([["a3", "c1"], ["b2"]], 15, 64, 48, 0.25, 2, 16),
}


def _batch_pair(jev, tev, k, beta, max_depth):
    jsim, jbatch = jax_core.make_kernels(jax_engine(3), jev, max_depth=max_depth)
    tsim, tbatch = torch_core.make_kernels(torch_engine(3), tev, max_depth=max_depth)
    jrun = jax.jit(lambda t: jbatch(jsim(t, beta), beta, k))
    return jrun, lambda t: tbatch(tsim(t, beta), beta, k)


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_simulate_batch_matches_jax(case):
    openings, k, nodes, children, beta, chunks, depth = BATCH_CASES[case]
    jeng, teng, jev, tev = _dummy(3)
    jrun, trun = _batch_pair(jev, tev, k, beta, depth)
    js = _roots(3, openings)
    jt = jax_tree.init_tree(jeng, js, nodes, children)
    tt = torch_tree.init_tree(teng, state_to_torch(js), nodes, children)
    for i in range(chunks):
        jt, tt = jrun(jt), trun(tt)
        assert_tree_equal(tt, jt, f"{case} chunk {i}", _tol(1e-6))
    valid = tt.child_action[:, 0, :] >= 0
    assert torch.equal(tt.root_visit, torch.where(valid, tt.child_visit[:, 0, :], 0).sum(-1, dtype=torch.int32) + 1)


def test_simulate_batch_proves_tinue_as_jax():
    jev, tev = jax_agents.dummy_evaluator(jax_engine(3)), torch_agents.dummy_evaluator(torch_engine(3))
    jrun, trun = _batch_pair(jev, tev, 63, 1.0, 32)
    _prove_tinue(jrun, trun)


def test_make_kernels_pair_and_simulate_launch_counts():
    """``make_kernels`` returns ``(simulate, simulate_batch)``; a batch of K
    makes K+1 top-k calls with a plain simulate before it, and one
    evaluator call over the K*B stacked leaves."""
    teng = torch_engine(3)
    calls = []
    base = torch_agents.dummy_evaluator(teng)

    def counting(envs):
        calls.append(envs.ply.shape[0])
        return base(envs)

    simulate, simulate_batch = torch_core.make_kernels(teng, counting, max_depth=16)
    tt = torch_tree.init_tree(teng, state_to_torch(_roots(3, [["b2"], ["a1"]])), 32, 48)
    simulate_batch(simulate(tt, 0.0), 0.0, 5)
    assert calls == [2, 10]
    # make_simulate and make_simulate_batch wrap the same pair.
    simulate = torch_core.make_simulate(teng, counting, max_depth=16)
    simulate_batch = torch_core.make_simulate_batch(teng, counting, max_depth=16)
    simulate_batch(simulate(tt, 0.0), 0.0, 3)
    assert calls == [2, 10, 2, 6] and (tt.root_visit == 6 + 4).all()


# ---------------------------------------------------------------------------
# descend_host / descend_device on a searched tree (tests/test_descend.py).
# ---------------------------------------------------------------------------


def _searched_jax_tree():
    """JAX's ``_searched_tree``: 64 simulations of the simple evaluator."""
    eng = jax_engine(3)
    simulate, simulate_batch = jax_core.make_kernels(eng, jax_agents.simple_evaluator(eng), max_depth=16)

    @jax.jit
    def run(tree):
        tree = simulate(tree, jnp.zeros(1))
        left = 63
        while left > 0:
            k = min(16, left)
            tree = simulate_batch(tree, jnp.zeros(1), k)
            left -= k
        return tree

    return run(jax_tree.init_tree(eng, _roots(3, [["a3", "c1"]]), 256, 48))


def test_descend_host_and_device_match_jax():
    jt = _searched_jax_tree()
    tt = tree_to_torch(jt)
    ca, cv, cn = (np.asarray(a[0, 0]) for a in (jt.child_action, jt.child_visit, jt.child_node))
    best = int(ca[int(np.argmax(np.where(cn >= 0, cv, -1)))])
    unexpanded = np.nonzero((ca >= 0) & (cn < 0))[0]
    assert len(unexpanded), "premise: the searched root has a child never expanded"
    never = int(ca[int(unexpanded[0])])
    not_child = next(a for a in range(100) if a not in set(ca.tolist()))
    jdesc = jax.jit(jax_tree.descend_device)

    # The most visited expanded child: both descents equal JAX's, exactly.
    jh = jax_tree.descend_host(jt, best)
    th = torch_tree.descend_host(tt, best)
    assert_tree_equal(th, jh, "descend_host")
    jd, jok = jdesc(jt, jnp.int32(best))
    td, tok = torch_tree.descend_device(tt, best)
    assert bool(jok) and bool(tok)
    assert_tree_equal(td, jd, "descend_device")
    assert int(td.root_visit[0]) == int(cv[list(ca).index(best)])
    # descend_device leaves its input as it was.
    assert_tree_equal(tt, jt, "input after descend_device")

    # A child never expanded, and an action that is not a root child.
    for action in (never, not_child):
        assert jax_tree.descend_host(jt, action) is None
        assert torch_tree.descend_host(tt, action) is None
        _, jok = jdesc(jt, jnp.int32(action))
        _, tok = torch_tree.descend_device(tt, action)
        assert not bool(jok) and not bool(tok)

    # Further search on the descended trees goes as JAX's does.
    jeng, teng = jax_engine(3), torch_engine(3)
    jsim, jbatch = jax_core.make_kernels(jeng, jax_agents.simple_evaluator(jeng), max_depth=16)
    tsim, tbatch = torch_core.make_kernels(teng, torch_agents.simple_evaluator(teng), max_depth=16)
    more = jax.jit(lambda t: jbatch(jsim(t, jnp.zeros(1)), jnp.zeros(1), 15))
    # The simple evaluator's priors differ from XLA's in the last float32
    # bits (ROADMAP.md queue 3); the selections must not.
    tol = {"child_prob": 1e-6, "root_value": 1e-6, "child_value": 1e-6}
    for where, j, t in (("host", jh, th), ("device", jd, td)):
        assert_tree_equal(tbatch(tsim(t, 0.0), 0.0, 15), more(j), f"search after descend_{where}", tol)


# ---------------------------------------------------------------------------
# Openings with random plies.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,steps", [(3, 2), (5, 2), (4, 3)])
def test_new_opening_random_steps_match_jax(n, steps):
    key = jax.random.PRNGKey(n + steps)
    batch = 16
    want = jax_opening(jax_engine(n), random_steps=steps)(key, batch)
    k_sym, k_pair, k_steps = jax.random.split(key, 3)
    sym = torch.from_numpy(np.array(jax.random.randint(k_sym, (batch,), 0, 8))).long()
    pair = torch.from_numpy(np.array(jax.random.randint(k_pair, (batch,), 0, 2))).long()
    a = torch_engine(n).num_actions
    gumbel = torch.from_numpy(np.stack([
        np.array(jax.random.gumbel(jax.random.fold_in(k_steps, i), (batch, a))) for i in range(steps)
    ]))
    got = make_new_opening(torch_engine(n), random_steps=steps)(sym, pair, gumbel)
    assert_state_equal(got, want, f"{n}x{n} opening, {steps} random plies")
    assert (got.ply.numpy() == 2 + steps).all()
    with pytest.raises(ValueError, match="random plies"):
        make_new_opening(torch_engine(n), random_steps=steps)(sym, pair)


def test_new_opening_keeps_finished_games():
    """A game that ends during the random plies keeps its final position
    (JAX freezes terminal lanes the same way)."""
    teng = torch_engine(3)
    opening = make_new_opening(teng, random_steps=6)
    gen = torch.Generator().manual_seed(0)
    sym = torch.randint(0, 8, (256,), generator=gen)
    pair = torch.randint(0, 2, (256,), generator=gen)
    gumbel = -torch.log(-torch.log(torch.rand((6, 256, teng.num_actions), generator=gen).clamp(min=1e-30)))
    got = opening(sym, pair, gumbel)
    ended = teng.terminal_kind(got) != 0
    assert bool(ended.any())
    # Replaying one ply fewer: lanes already over at 5 plies did not move.
    five = make_new_opening(teng, random_steps=5)(sym, pair, gumbel[:5])
    over = teng.terminal_kind(five) != 0
    assert torch.equal(got.ply[over], five.ply[over])
