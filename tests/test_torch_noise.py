"""The port's Dirichlet root noise (``takzero_torch/search/noise.py``) and
UCT scores (``search/policy.py`` ``uct_scores``) against the JAX package's.

* ``tests/test_noise.py``'s cases on the port's own searched 3x3 tree
  (``simple_evaluator``, one simulation): the noised root still sums to 1
  over the same support, noise moved mass, the logits are ln(p'), and
  ratio 0 leaves the probabilities as they were; the gamma draws come from
  :func:`gamma_draws` on a ``torch.Generator``.
* ``apply_dirichlet`` against JAX's on JAX's tree and JAX's
  ``jax.random.gamma`` draws of the same key: integers exactly, floats
  within 1e-6.
* ``tests/test_mcts.py::test_uct_scores_reference_formula``, and
  ``uct_scores`` against JAX's on a searched tree at scalar and per-root
  visit counts and betas: the same -inf slots, floats within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.search import eval as jax_ev
from takzero_tpu.search.agents import simple_evaluator as jax_simple_evaluator
from takzero_tpu.search.core import make_simulate as jax_make_simulate
from takzero_tpu.search.noise import apply_dirichlet as jax_apply_dirichlet
from takzero_tpu.search.openings import make_new_opening as jax_new_opening
from takzero_tpu.search.policy import uct_scores as jax_uct_scores
from takzero_tpu.search.tree import init_tree as jax_init_tree
from takzero_tpu.tak import engine as jax_engine
from takzero_torch.search import eval as ev
from takzero_torch.search.agents import simple_evaluator
from takzero_torch.search.core import make_simulate
from takzero_torch.search.noise import apply_dirichlet, gamma_draws
from takzero_torch.search.openings import make_new_opening
from takzero_torch.search.policy import uct_scores
from takzero_torch.search.tree import init_tree
from takzero_torch.tak.engine import engine

from torch_parity import opening_draws, tree_to_torch


def _port_tree(sims: int = 1):
    eng = engine(3)
    draws = opening_draws(jax.random.PRNGKey(0), 4)
    envs = make_new_opening(eng)(draws["open_sym"], draws["open_pair"])
    tree = init_tree(eng, envs, max_nodes=8 + sims, max_children=48)
    simulate = make_simulate(eng, simple_evaluator(eng), max_depth=8)
    for _ in range(sims):
        tree = simulate(tree, torch.zeros(4))
    return tree


@functools.lru_cache(maxsize=None)
def _jax_tree(sims: int = 1):
    eng = jax_engine(3)
    simulate = jax.jit(jax_make_simulate(eng, jax_simple_evaluator(eng), max_depth=8))
    envs = jax_new_opening(eng)(jax.random.PRNGKey(0), 4)
    tree = jax_init_tree(eng, envs, max_nodes=8 + sims, max_children=48)
    for _ in range(sims):
        tree = simulate(tree, jnp.zeros(4))
    return tree


def test_distribution_stays_1_after_noise():
    tree = _port_tree()
    valid = tree.child_action[:, 0, :] >= 0
    before = tree.child_prob[:, 0, :].clone()
    torch.testing.assert_close(before.sum(-1), torch.ones(4), rtol=0, atol=1e-5)
    gamma = gamma_draws(torch.Generator().manual_seed(7), 0.3, before.shape)
    noised = apply_dirichlet(tree, gamma, ratio=0.25)
    after = noised.child_prob[:, 0, :]
    torch.testing.assert_close(after.sum(-1), torch.ones(4), rtol=0, atol=1e-5)
    assert (after[~valid] == 0).all() and (after[valid] >= 0).all()
    assert (after - before).abs().max() > 1e-6
    torch.testing.assert_close(torch.where(valid, noised.child_logit[:, 0, :].exp(), 0.0), after, rtol=0, atol=1e-5)
    assert torch.equal(tree.child_prob[:, 0, :], before)  # the input tree is unchanged


def test_ratio_zero_is_identity():
    tree = _port_tree()
    gamma = gamma_draws(torch.Generator().manual_seed(3), 0.5, tree.child_prob[:, 0, :].shape)
    noised = apply_dirichlet(tree, gamma, ratio=0.0)
    torch.testing.assert_close(noised.child_prob[:, 0, :], tree.child_prob[:, 0, :], rtol=0, atol=1e-6)


@pytest.mark.parametrize("alpha,ratio", [(0.3, 0.25), (0.03, 0.5), (1.0, 1.0)])
def test_apply_dirichlet_matches_jax(alpha, ratio):
    jtree = _jax_tree()
    key = jax.random.PRNGKey(11)
    b, c = jtree.child_prob[:, 0, :].shape
    gamma = torch.from_numpy(np.array(jax.random.gamma(key, jnp.float32(alpha), shape=(b, c))))
    want = jax_apply_dirichlet(jtree, key, alpha, ratio)
    got = apply_dirichlet(tree_to_torch(jtree), gamma, ratio)
    for name in ("child_prob", "child_logit"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    for name in ("child_action", "child_visit", "child_flag"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_uct_scores_reference_formula():
    eng = engine(3)
    draws = opening_draws(jax.random.PRNGKey(0), 1)
    tree = init_tree(eng, make_new_opening(eng)(draws["open_sym"], draws["open_pair"]), max_nodes=8,
                     max_children=48)
    tree.child_action[0, 0, :2] = torch.tensor([5, 6])
    tree.child_visit[0, 0, :2] = torch.tensor([4, 1])
    tree.child_value[0, 0, 0] = 0.25
    tree.child_flag[0, 0, 1] = ev.WIN
    tree.child_ply[0, 0, 1] = 1
    s = uct_scores(tree, torch.tensor([5.0]), 0.0)[0]
    # Slot 0: q = -0.25 (negated), u = sqrt(ln 5 / 4).
    assert s[0].item() == pytest.approx(-0.25 + np.sqrt(np.log(5.0) / 4.0), rel=1e-6)
    assert s[1].item() == -np.inf  # a winning child, pruned (the root is not a proven loss)
    assert (s[2:] == -np.inf).all()  # invalid slots
    tree.root_flag[0] = ev.LOSS
    assert np.isfinite(uct_scores(tree, 5.0, 0.0)[0, 1].item())  # kept under a proven loss


@pytest.mark.parametrize("per_root", [False, True])
def test_uct_scores_match_jax(per_root):
    jtree = _jax_tree(sims=6)
    # A proven-loss root and a winning child, so both branches of the pruning run.
    jtree = jtree._replace(root_flag=jtree.root_flag.at[1].set(jax_ev.LOSS),
                           child_flag=jtree.child_flag.at[:2, 0, 0].set(jax_ev.WIN))
    tree = tree_to_torch(jtree)
    if per_root:
        visits, beta = np.array([7.0, 1.0, 3.0, 0.0], np.float32), np.array([0.0, 0.5, -0.25, 1.0], np.float32)
        got = uct_scores(tree, torch.from_numpy(visits), torch.from_numpy(beta)).numpy()
        want = np.asarray(jax_uct_scores(jtree, jnp.asarray(visits), jnp.asarray(beta)))
    else:
        got, want = uct_scores(tree, 7.0, 0.5).numpy(), np.asarray(jax_uct_scores(jtree, 7.0, 0.5))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(want[~np.isneginf(want)]).all() and (~np.isneginf(want)).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
