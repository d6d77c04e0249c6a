"""The phases of a simulation of ``search/core.py`` on the CPU.

A simulation is the descent, the forward tail ``settle``, the evaluator,
``apply_eval`` and the backup; a search on a CUDA device replays each
phase from a CUDA graph.  Off the card a search runs every phase eagerly,
and only an evaluator that declares itself capturable is captured.  Over
whole CPU searches each simulation's descent and backup equal their
lane-wise statements (``search/lanewise.py``, what the card's kernels do),
and the deepest level the backup reaches, read from the descent's outputs
before the middle, equals the one read after it.  The card's side (the
graphed search equal to the batched loops after every simulation) is
``tests/test_torch_cuda.py``.
"""

import contextlib

import pytest
import torch
from test_torch_lanewise import assert_same, clone

from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.models.network import NetConfig
from takzero_torch.search import core, graphs, gumbel
from takzero_torch.search.agents import simple_evaluator
from takzero_torch.search.lanewise import backup_plain, descend_plain
from takzero_torch.search.openings import make_new_opening
from takzero_torch.search.tree import init_tree
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak.engine import engine

torch.set_num_threads(2)


def _search_inputs(n: int, seed: int, b: int = 8, c: int = 64):
    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(seed)
    envs = make_new_opening(eng)(torch.randint(0, 8, (b,), generator=gen), torch.randint(0, 2, (b,), generator=gen))
    return eng, envs, gumbel_noise(gen, (b, c)), torch.rand(b, generator=gen) * 0.5


def _checked_make_simulate(reads: list):
    """``make_simulate`` whose simulations run the phases one by one, hold
    the descent and the backup to ``descend_plain`` and ``backup_plain``
    run from copies of the same tree, and record the deepest level to back
    up as read from the descent's outputs (before the middle) and from
    ``settle``'s (after it)."""

    def make_simulate(eng, evaluator, max_depth=48, topk="auto"):
        phases = core.make_simulate(eng, evaluator, max_depth=max_depth, topk=topk).phases

        def simulate(tree, beta, forced_slot=None, *, skip_root=False):
            beta = core._betas(tree, beta)
            plain = clone(tree)
            loop = phases["descend"](tree, beta, forced_slot, skip_root)
            assert_same(descend_plain(plain, beta, forced_slot, skip_root, max_depth), loop, "descent")
            assert_same(plain, tree, "tree after the descent")
            # Known stops, depth clips and leaves reach their length; settle
            # sets a clipped lane's to max_depth.
            reach = loop["stop_known"] | loop["active"] | loop["stop_leaf"]
            before = int(torch.where(reach, torch.where(loop["active"], max_depth, loop["length"]), 0).max())
            rec = phases["settle"](tree, loop)
            logits, v_net, var_net = evaluator(rec["env_eval"])
            phases["apply_eval"](tree, rec, logits, v_net, var_net)
            after = int(torch.where(rec["stop_known"] | rec["lane_eval_leaf"], rec["length"], 0).max())
            reads.append((before, after))
            plain = clone(tree)
            phases["backward"](tree, rec, v_net, var_net, skip_root)
            assert_same(backup_plain(plain, rec, v_net, var_net, skip_root), tree, "tree after the backup")
            return tree

        simulate.search_scope = lambda tree: contextlib.nullcontext(simulate)
        return simulate

    return make_simulate


@pytest.mark.parametrize("n,seed,depth", [(6, 1, 2), (6, 2, 48), (5, 3, 2), (5, 4, 48)])
def test_backup_depth_read_before_the_middle_equals_the_one_after(monkeypatch, n, seed, depth):
    """Over whole Gumbel searches (8 games, k=8, budget 48, C=64, the
    simple evaluator; the depth clipped at 2, where clipped lanes are
    backed up, or at 48), each simulation's descent and backup equal the
    lane-wise walks of the card's kernels, the depth read before the middle
    equals the one after it, and the search that runs the phases one by one
    builds the trees of the search as it runs."""
    eng, envs, noise, betas = _search_inputs(n, seed)
    budget = 48
    out = {}
    for checked in (False, True):
        reads: list = []
        with monkeypatch.context() as m:
            if checked:
                m.setattr(gumbel, "make_simulate", _checked_make_simulate(reads))
            search = gumbel.make_gumbel_search(eng, simple_evaluator(eng), 8, budget, max_depth=depth)
            out[checked] = search(init_tree(eng, envs, budget + 8, 64), noise, betas)
        if checked:
            assert len(reads) == budget + 1
            assert all(before == after for before, after in reads), reads
            assert depth > 2 or any(before == depth for before, _ in reads)  # a clipped lane backed up
    (tree, slot), (ref, ref_slot) = out[True], out[False]
    assert torch.equal(slot, ref_slot)
    assert_same(tree, ref, "searched tree")


def test_a_search_off_the_card_runs_every_middle_eagerly():
    """A CPU search engages no graph: its scope is ``simulate`` itself and
    the engagement counter counts budget + 1 eager middles."""
    eng, envs, noise, betas = _search_inputs(6, 5)
    simulate = core.make_simulate(eng, simple_evaluator(eng))
    tree = init_tree(eng, envs, 24, 64)
    with simulate.search_scope(tree) as sim:
        assert sim is simulate
    before = dict(graphs.MIDDLES)
    gumbel.make_gumbel_search(eng, simple_evaluator(eng), 8, 24)(tree, noise, betas)
    assert {k: graphs.MIDDLES[k] - before[k] for k in before} == {"eager": 25, "captured": 0, "replayed": 0}


def test_only_the_net_evaluator_of_one_process_declares_itself_capturable():
    """``make_net_evaluate``'s evaluator is capturable without a ``world``,
    and ``with_agent`` carries the declaration; a plain function or a
    lambda declares nothing."""
    eng = engine(3, half_komi=0)
    cfg = NetConfig(n=3, half_komi=0, filters=8, blocks=1, novelty="none")
    evaluate = make_net_evaluate(cfg, eng, device="cpu")
    assert evaluate.capturable is True and core.with_agent(evaluate, {}).capturable is True
    world = type("World", (), {"at_global_shape": staticmethod(lambda networks: networks)})()
    assert make_net_evaluate(cfg, eng, device="cpu", world=world).capturable is False
    for plain in (simple_evaluator(eng), lambda agent, envs: None):
        assert core.with_agent(plain, {}).capturable is False
