"""7x7 and 8x8: the port's network and Gumbel search against JAX's.

Counterpart of ``tests/test_bigboards.py``.  At n = 7 and n = 8
(``NetConfig(n, half_komi=4, filters=8, blocks=1, novelty="none")``, two
games, k=4, budget 16, 24 pool rows, 64 child slots) the port's search on
the CPU runs from JAX's bridged weights, in float32 on both sides, and
with JAX's draws: the openings of ``new_opening(PRNGKey(0), 2)`` and the
root Gumbels of ``PRNGKey(1)``.  Trees must be equal under the tolerances
of ``tests/test_torch_selfplay.py``'s network case (the two frameworks sum
the convolutions in different orders: float arrays to 1e-4, everything
else exactly); chosen actions must be equal and legal, and the root-visit
invariant of the JAX test must hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.models.agent import make_net_evaluate as jax_net_evaluate
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.models.network import NetConfig as JaxNetConfig
from takzero_tpu.search.gumbel import make_gumbel_search as jax_gumbel_search
from takzero_tpu.search.openings import make_new_opening as jax_new_opening
from takzero_tpu.search.policy import slot_action as jax_slot_action
from takzero_tpu.search.tree import init_tree as jax_init_tree
from takzero_tpu.tak.engine import TakEngine as JaxEngine
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.models.network import NetConfig
from takzero_torch.search.gumbel import make_gumbel_search
from takzero_torch.search.openings import make_new_opening
from takzero_torch.search.policy import slot_action
from takzero_torch.search.tree import init_tree
from takzero_torch.tak.engine import TakEngine

from torch_parity import assert_state_equal, assert_tree_equal, opening_draws, search_draws

torch.set_num_threads(2)

GAMES, K, BUDGET, ROWS, CHILDREN, DEPTH = 2, 4, 16, 24, 64, 16
TOL = {f: 1e-4 for f in ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")}


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


@pytest.mark.parametrize("n", [7, 8])
def test_network_gumbel_search_big_boards_matches_jax(n):
    jcfg = JaxNetConfig(n=n, half_komi=4, filters=8, blocks=1, novelty="none", compute_dtype=jnp.float32)
    tcfg = NetConfig(n=n, half_komi=4, filters=8, blocks=1, novelty="none", compute_dtype=torch.float32)
    jeng, teng = JaxEngine(n=n, half_komi=4), TakEngine(n=n, half_komi=4)
    jagent = jax_new_agent(jcfg, 0)
    tagent = from_jax_bundle(jax.tree.map(np.asarray, jagent), tcfg, device="cpu")
    jevaluate, tevaluate = jax_net_evaluate(jcfg, jeng), make_net_evaluate(tcfg, teng, device="cpu")

    jenvs = jax_new_opening(jeng)(jax.random.PRNGKey(0), GAMES)
    draws = opening_draws(jax.random.PRNGKey(0), GAMES)
    tenvs = make_new_opening(teng)(draws["open_sym"], draws["open_pair"])
    assert_state_equal(tenvs, jenvs, f"n={n} openings")
    for name, t, j in zip(("policy", "value", "variance"), tevaluate(tagent, tenvs), jevaluate(jagent, jenvs)):
        assert t.shape == j.shape and bool(torch.isfinite(t).all()), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=f"n={n}: {name}")

    jsearch = jax.jit(jax_gumbel_search(jeng, lambda e: jevaluate(jagent, e), K, BUDGET, max_depth=DEPTH))
    tsearch = make_gumbel_search(teng, lambda e: tevaluate(tagent, e), K, BUDGET, max_depth=DEPTH)
    key = jax.random.PRNGKey(1)
    jtree, jslot = jsearch(jax_init_tree(jeng, jenvs, max_nodes=ROWS, max_children=CHILDREN), key, jnp.zeros(GAMES))
    ttree, tslot = tsearch(init_tree(teng, tenvs, max_nodes=ROWS, max_children=CHILDREN),
                           search_draws(key, GAMES, CHILDREN), torch.zeros(GAMES))
    assert_tree_equal(ttree, jtree, f"n={n} search", TOL)
    acts = slot_action(ttree, tslot)
    np.testing.assert_array_equal(acts.numpy(), np.asarray(jax_slot_action(jtree, jslot)))
    assert bool(teng.legal_mask(tenvs).gather(1, acts.long()[:, None]).all())
    # Root visit = sum of the valid children's visits + 1.
    valid = ttree.child_action[:, 0, :] >= 0
    cv = torch.where(valid, ttree.child_visit[:, 0, :], 0).sum(-1)
    assert torch.equal(ttree.root_visit.long(), cv.long() + 1)
