"""The port's search (takzero_torch.search) against the JAX search.

``simulate``, the Gumbel sequential-halving search and the re-rooting
(``descend_batch`` + ``reset_lanes``) run from the same trees in both
packages, with the dummy and the simple evaluator, on fresh and descended
trees.  After every step each ``Tree`` array must equal JAX's exactly,
except the scratch row (the last pool row, a write sink whose content is
garbage by design).

Off the TPU, JAX's ``make_topk`` defaults to ``lax.top_k``, whose slot order
is sorted and whose ties differ from the TPU kernel's.  ``TAKZERO_TOPK`` is
set to ``exact_ref`` before any JAX search is traced, so that JAX selects
children as the TPU kernel does (ties to the lower index, ascending index
order), which is the port's contract too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.search import agents as jax_agents
from takzero_tpu.search import core as jax_core
from takzero_tpu.search import gumbel as jax_gumbel
from takzero_tpu.search import policy as jax_policy
from takzero_tpu.search import tree as jax_tree
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak.state import TakState as JaxState
from takzero_tpu.tak.state import initial_state_batch as jax_initial_batch
from takzero_torch.search import agents as torch_agents
from takzero_torch.search import core as torch_core
from takzero_torch.search import gumbel as torch_gumbel
from takzero_torch.search import policy as torch_policy
from takzero_torch.search import tree as torch_tree
from takzero_torch.tak import engine as torch_engine

from torch_parity import assert_tree_equal, state_to_torch

torch.set_num_threads(2)

BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _roots(n: int, seed: int) -> JaxState:
    """BATCH non-terminal positions: 2-5 random legal plies from the start."""
    eng = jax_engine(n)
    legal = jax.jit(jax.vmap(eng.legal_mask))
    step = jax.jit(jax.vmap(eng.step))
    rng = np.random.default_rng(seed)
    plies = rng.integers(2, 6, size=BATCH)
    js = jax_initial_batch(n, BATCH)
    for p in range(int(plies.max())):
        mask = np.asarray(legal(js))
        acts = np.array([rng.choice(np.flatnonzero(m)) for m in mask], np.int32)
        nxt = step(js, jnp.asarray(acts))
        keep = jnp.asarray(p < plies)
        js = JaxState(*(
            jnp.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)), b, a)
            for a, b in zip(js, nxt)
        ))
    return js


_EVALUATORS = {
    "dummy": (jax_agents.dummy_evaluator, torch_agents.dummy_evaluator),
    "simple": (jax_agents.simple_evaluator, torch_agents.simple_evaluator),
}

# The priors are a softmax of the logits.  XLA's CPU ``exp`` and torch's
# differ in the last bit for about one input in ten, so where the logits
# are not all equal (the simple evaluator) ``child_prob``, and the root
# value that the Gumbel search recomputes as a prior-weighted mean, agree
# to a few float32 ulps (2^-23 = 1.2e-7 relative).  Every other array, and
# every selection made from the priors, must still match exactly.
_RTOL = {"dummy": None, "simple": {"child_prob": 1e-6, "root_value": 1e-6}}


# (board, child slots, evaluator): C=32 holds every 3x3 move; C=8 and
# C=16 truncate, so incomplete nodes and the top-k cut are exercised.
@pytest.mark.parametrize(
    "n,children,evaluator",
    [(3, 32, "dummy"), (3, 8, "simple"), (4, 16, "dummy")],
)
def test_simulate_and_descend_match_jax(n, children, evaluator):
    jeng, teng = jax_engine(n), torch_engine(n)
    jev, tev = (f(e) for f, e in zip(_EVALUATORS[evaluator], (jeng, teng)))
    jsim = jax.jit(jax_core.make_simulate(jeng, jev, max_depth=12))
    tsim = torch_core.make_simulate(teng, tev, max_depth=12)
    jbest = jax.jit(jax_policy.select_best_slot)
    jdesc = jax.jit(lambda t, s: jax_tree.descend_batch(t, s, min_headroom=4, max_chain=12))
    jreset = jax.jit(jax_tree.reset_lanes)

    js = _roots(n, seed=n + children)
    jt = jax_tree.init_tree(jeng, js, max_nodes=48, max_children=children)
    tt = torch_tree.init_tree(teng, state_to_torch(js), max_nodes=48, max_children=children)
    assert_tree_equal(tt, jt, "init")
    betas = np.array([0.25, 0.0, 0.5, 0.0], np.float32)
    for i in range(14):
        jt = jsim(jt, jnp.asarray(betas))
        tt = tsim(tt, torch.from_numpy(betas))
        assert_tree_equal(tt, jt, f"fresh sim {i}", _RTOL[evaluator])

    # Re-root at the best child; lanes that cannot carry their subtree
    # restart from the chosen child's position.
    jslot = jbest(jt)
    tslot = torch_policy.select_best_slot(tt)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    jt2, jok = jdesc(jt, jslot)
    tt2, tok = torch_tree.descend_batch(tt, tslot, min_headroom=4, max_chain=12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    action = np.asarray(jax_policy.slot_action(jt, jslot))
    np.testing.assert_array_equal(torch_policy.slot_action(tt, tslot).numpy(), action)
    stepped = jax.vmap(jeng.step)(js, jnp.asarray(action).clip(0))
    reset = ~np.asarray(jok)
    reset[0] = True  # always exercise reset_lanes on one lane
    jt2 = jreset(jt2, jnp.asarray(reset), stepped)
    tt2 = torch_tree.reset_lanes(tt2, torch.from_numpy(reset), state_to_torch(stepped))
    assert_tree_equal(tt2, jt2, "descended", _RTOL[evaluator])
    for i in range(10):
        jt2 = jsim(jt2, jnp.asarray(betas))
        tt2 = tsim(tt2, torch.from_numpy(betas))
        assert_tree_equal(tt2, jt2, f"descended sim {i}", _RTOL[evaluator])


@pytest.mark.parametrize("evaluator", ["dummy", "simple"])
def test_gumbel_search_matches_jax(evaluator):
    n, children, k, budget = 3, 32, 4, 16
    jeng, teng = jax_engine(n), torch_engine(n)
    jev, tev = (f(e) for f, e in zip(_EVALUATORS[evaluator], (jeng, teng)))
    jsearch = jax.jit(jax_gumbel.make_gumbel_search(jeng, jev, k, budget, max_depth=12))
    tsearch = torch_gumbel.make_gumbel_search(teng, tev, k, budget, max_depth=12)
    js = _roots(n, seed=11)
    jt = jax_tree.init_tree(jeng, js, max_nodes=40, max_children=children)
    tt = torch_tree.init_tree(teng, state_to_torch(js), max_nodes=40, max_children=children)
    betas = np.array([0.0, 0.25, 0.0, 0.25], np.float32)
    for rep in range(2):
        key = jax.random.PRNGKey(rep)
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (BATCH, children))))
        jt, jslot = jsearch(jt, key, jnp.asarray(betas))
        tt, tslot = tsearch(tt, gumbel, torch.from_numpy(betas))
        assert_tree_equal(tt, jt, f"search {rep}", _RTOL[evaluator])
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
