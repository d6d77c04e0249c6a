"""The split simulation of ``search/core.py`` on the CPU.

A simulation is the descent's level loop, its fixed-shape middle (the
forward tail ``settle``, the evaluator and ``apply_eval``, which a search on
a CUDA device replays from graphs) and the backup.  The backup's deepest
level is read on the host right after the loop, before the middle: here it
must equal the value read after the middle, over whole searches.  Off the
card a search runs every middle eagerly.  The card's side (graphs equal to
the eager search bit for bit) is ``tests/test_torch_cuda.py``.
"""

import contextlib

import pytest
import torch

from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.models.network import NetConfig
from takzero_torch.search import core, gumbel
from takzero_torch.search.agents import simple_evaluator
from takzero_torch.search.openings import make_new_opening
from takzero_torch.search.tree import init_tree
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak.engine import engine

torch.set_num_threads(2)


def _checked_make_simulate(reads: list):
    """``make_simulate`` whose simulations run the phases one by one and
    record the backup depth read before the middle and after it."""

    def make_simulate(eng, evaluator, max_depth=48, topk="auto"):
        phases = core.make_simulate(eng, evaluator, max_depth=max_depth, topk=topk).phases

        def simulate(tree, beta, forced_slot=None, *, skip_root=False):
            loop = phases["descend"](tree, core._betas(tree, beta), forced_slot, skip_root)
            before = phases["backup_depth"](loop)
            rec = phases["settle"](tree, loop)
            logits, v_net, var_net = evaluator(rec["env_eval"])
            phases["apply_eval"](tree, rec, logits, v_net, var_net)
            after = int(torch.where(rec["stop_known"] | rec["lane_eval_leaf"], rec["length"], 0).max())
            reads.append((before, after))
            return phases["backward"](tree, rec, v_net, var_net, skip_root)

        simulate.search_scope = lambda tree: contextlib.nullcontext(simulate)
        return simulate

    return make_simulate


def _search_inputs(n: int, seed: int, b: int = 8, c: int = 64):
    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(seed)
    envs = make_new_opening(eng)(torch.randint(0, 8, (b,), generator=gen), torch.randint(0, 2, (b,), generator=gen))
    return eng, envs, gumbel_noise(gen, (b, c)), torch.rand(b, generator=gen) * 0.5


@pytest.mark.parametrize("n,seed,depth", [(6, 1, 2), (6, 2, 48), (5, 3, 2), (5, 4, 48)])
def test_backup_depth_read_before_the_middle_equals_the_one_after(monkeypatch, n, seed, depth):
    """Over whole Gumbel searches (8 games, k=8, budget 48, C=64, the
    simple evaluator; the depth clipped at 2, where clipped lanes occur, or
    at 48), the read before the middle equals the read after it, and the
    search that hoists the read builds the trees of the search that does
    not."""
    eng, envs, noise, betas = _search_inputs(n, seed)
    budget = 48
    out = {}
    for hoisted in (True, False):
        reads: list = []
        with monkeypatch.context() as m:
            if not hoisted:
                m.setattr(gumbel, "make_simulate", _checked_make_simulate(reads))
            search = gumbel.make_gumbel_search(eng, simple_evaluator(eng), 8, budget, max_depth=depth)
            out[hoisted] = search(init_tree(eng, envs, budget + 8, 64), noise, betas)
        if not hoisted:
            assert len(reads) == budget + 1
            assert all(before == after for before, after in reads), reads
            assert depth > 2 or any(before == depth for before, _ in reads)  # a clipped lane backed up
    (tree, slot), (ref, ref_slot) = out[True], out[False]
    assert torch.equal(slot, ref_slot)
    for name, x in tree._asdict().items():
        for u, v in (zip(x, getattr(ref, name)) if name == "node_env" else [(x, getattr(ref, name))]):
            assert torch.equal(u, v), name


def test_a_search_off_the_card_runs_every_middle_eagerly():
    """A CPU search engages no graph: its scope is ``simulate`` itself and
    the engagement counter counts budget + 1 eager middles."""
    eng, envs, noise, betas = _search_inputs(6, 5)
    simulate = core.make_simulate(eng, simple_evaluator(eng))
    tree = init_tree(eng, envs, 24, 64)
    with simulate.search_scope(tree) as sim:
        assert sim is simulate
    before = dict(core.MIDDLES)
    gumbel.make_gumbel_search(eng, simple_evaluator(eng), 8, 24)(tree, noise, betas)
    assert {k: core.MIDDLES[k] - before[k] for k in before} == {"eager": 25, "captured": 0, "replayed": 0}


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
