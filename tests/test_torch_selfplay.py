"""The port's selfplay move program against ``SelfplayEngine._move``.

The whole slice at ``tiny3``: batch 4, budget 16, k=4, C=32, tree reuse,
three moves.  The port's draws are rebuilt from the JAX program's keys
(``torch_parity.move_draws``), so both programs see the same randomness.
With the dummy evaluator the packed move output, the next states and the
carried trees must equal JAX's exactly, apart from the improved policy
(see ``test_move_program_dummy_evaluator``); for the tiny3 network, carried
over through the bridge in float32, see ``test_move_program_network``.
``TAKZERO_TOPK=exact_ref`` makes JAX select children as the TPU kernel
does (see ``tests/test_torch_search.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.config import selfplay_preset as jax_selfplay_preset
from takzero_tpu.models.agent import make_net_evaluate as jax_net_evaluate
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.search.agents import dummy_evaluator as jax_dummy
from takzero_tpu.selfplay import SelfplayEngine as JaxSelfplay
from takzero_tpu.tak import engine as jax_engine
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS, selfplay_preset
from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.search.agents import dummy_evaluator
from takzero_torch.selfplay import SelfplayEngine, make_draws
from takzero_torch.tak import engine as torch_engine

from torch_parity import assert_state_equal, assert_tree_equal, move_draws, opening_draws

torch.set_num_threads(2)

BATCH, BUDGET, K, C, MOVES = 4, 16, 4, 32, 3
SP_KW = dict(batch=BATCH, search_budget=BUDGET, sampled_actions=K, max_children=C)


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _columns(packed: np.ndarray, n: int) -> dict:
    """Split a packed move buffer by the column cuts of JAX's
    ``SelfplayEngine.play_move``."""
    s = n * n
    cuts = np.cumsum([1, 1, 1, 1, 1, C, C, s, s, s, s, 4, 1, 1, 1, 2])
    assert packed.shape[1] == cuts[-1] + 1
    names = (
        "action", "tk", "res", "road", "ube", "pol", "child_actions", "height",
        "owner_lo", "owner_hi", "tops", "reserves", "to_move", "ply",
        "reversible", "trunc", "root_incomplete",
    )
    return dict(zip(names, np.split(packed, cuts, axis=1)))


def _assert_packed(tp: np.ndarray, jp: np.ndarray, float_tol: float, where: str) -> None:
    """Integer columns exactly; the float columns (UBE target and improved
    policy, stored as float32 bits) to ``float_tol``."""
    jc, tc = _columns(jp, 3), _columns(tp, 3)
    for name in jc:
        if name in ("ube", "pol"):
            np.testing.assert_allclose(
                tc[name].view(np.float32), jc[name].view(np.float32),
                rtol=float_tol, atol=float_tol, err_msg=f"{where}: {name}",
            )
        else:
            np.testing.assert_array_equal(tc[name], jc[name], err_msg=f"{where}: {name}")


def _play(jax_factory, torch_factory, agents):
    """Three moves in both programs; yields (move, JAX out, port out)."""
    jeng, teng = jax_engine(3), torch_engine(3)
    jsp = JaxSelfplay(jeng, jax_selfplay_preset("tiny3", **SP_KW), jax_factory(jeng))
    tsp = SelfplayEngine(teng, selfplay_preset("tiny3", **SP_KW), torch_factory(teng), device="cpu")
    jbundle, tagent = agents
    jsp.reset(jax.random.PRNGKey(5))
    tsp.reset(opening_draws(jax.random.PRNGKey(5), BATCH))
    assert_state_equal(tsp.envs, jsp.envs, "reset")
    jenvs, jtree, tenvs, ttree = jsp.envs, jsp.tree, tsp.envs, tsp.tree
    for move in range(MOVES):
        key = jax.random.PRNGKey(100 + move)
        jenvs, jtree, jpacked, _ = jsp._move(jenvs, jtree, jbundle, key)
        tenvs, ttree, tpacked, _ = tsp.move(tenvs, ttree, tagent, move_draws(key, BATCH, C))
        yield move, (jenvs, jtree, np.asarray(jpacked)), (tenvs, ttree, tpacked.numpy())


def test_move_program_dummy_evaluator():
    """Everything exact except the improved policy column.

    The improved policy is a softmax of ``logit + q * sqrt(visits)``; XLA
    contracts that into one fused multiply-add and evaluates ``exp`` with
    its own polynomial, torch rounds each operation and uses its own
    ``exp``.  At move 1 one root (lane 3) differs by 2 float32 ulps
    (0.04810207 in JAX, 0.04810206 here), so that column is held to 1e-6.
    """
    factory = lambda eng: (lambda bundle, envs: dummy_evaluator(eng)(envs))  # noqa: E731
    jfactory = lambda eng: (lambda bundle, envs: jax_dummy(eng)(envs))  # noqa: E731
    for move, (jenvs, jtree, jp), (tenvs, ttree, tp) in _play(jfactory, factory, (None, None)):
        _assert_packed(tp, jp, 1e-6, f"move {move}")
        assert_state_equal(tenvs, jenvs, f"move {move}: nxt")
        assert_tree_equal(ttree, jtree, f"move {move}: tree")


def test_move_program_network():
    """The bridged tiny3 network in float32.

    The two frameworks sum the convolutions in different orders, so logits,
    values and variances differ in the last float32 bits, and so do the
    priors, the improved policy and the UBE target derived from them.
    Integer columns (actions, results, next states, truncation) must match
    exactly; the float columns (UBE, improved policy) and the tree's float
    arrays to 1e-4, the network's own tolerance in
    ``tests/test_torch_repr_network.py``.
    """
    jcfg = dataclasses.replace(JAX_PRESETS["tiny3"], compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    jbundle = jax_new_agent(jcfg, seed=3)
    tagent = from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")
    jfactory = lambda eng: jax_net_evaluate(jcfg, eng)  # noqa: E731
    factory = lambda eng: make_net_evaluate(tcfg, eng, device="cpu")  # noqa: E731
    for move, (jenvs, jtree, jp), (tenvs, ttree, tp) in _play(jfactory, factory, (jbundle, tagent)):
        _assert_packed(tp, jp, 1e-4, f"move {move}")
        assert_state_equal(tenvs, jenvs, f"move {move}: nxt")
        tol = {f: 1e-4 for f in ("child_logit", "child_prob", "child_value", "child_std",
                                 "root_value", "root_std")}
        assert_tree_equal(ttree, jtree, f"move {move}: tree", tol)


def test_make_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = make_draws(g, 64, C)
    assert d["gumbel_root"].shape == d["gumbel_sample"].shape == (64, C)
    assert torch.isfinite(d["gumbel_root"]).all() and torch.isfinite(d["gumbel_sample"]).all()
    assert d["open_sym"].min() >= 0 and d["open_sym"].max() < 8
    assert d["open_pair"].min() >= 0 and d["open_pair"].max() < 2
    # Gumbel(0, 1) has mean Euler's gamma (0.577) and variance pi^2 / 6.
    g2 = make_draws(torch.Generator().manual_seed(1), 4096, 64)["gumbel_root"]
    assert abs(float(g2.mean()) - 0.5772) < 0.02
    assert abs(float(g2.var()) - np.pi**2 / 6) < 0.05
