"""The descent and backup kernels' per-lane algorithm against the batched
loops, on the CPU.

``search/lanewise.py`` states what the kernels of ``ops/tree.py`` do: each
lane walks its own path, one level at a time.  Here ``descend_plain`` and
``backup_plain`` must equal the batched loops of ``search/core.py`` (the
CPU's path, which the JAX parity tests hold) bit for bit, on trees built by
real Gumbel searches with a stub evaluator at 4x4 and 6x6, then marked with
proven wins, losses and draws, incomplete nodes and nodes whose valid
children are all proven wins.  The card's side (the kernels equal to both)
is ``tests/test_torch_cuda.py``.

Batch and slots: 16 lanes and C=64.  The CPU's ``torch.pow`` (the
discount of a proven eval) rounds its vectorised body and its scalar tail
apart, so a lane's row and the batch's rows take the same path only where
C is a multiple of 32 and a per-lane scalar meets fewer than 32 lanes: the
batched loops themselves give a lane bits that depend on its place in the
batch there.  On the card every element takes one path.
"""

import contextlib
import functools

import pytest
import torch

from takzero_torch.search import core, eval as ev, gumbel
from takzero_torch.search.lanewise import backup_plain, descend_plain
from takzero_torch.search.agents import simple_evaluator
from takzero_torch.search.tree import init_tree
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak.engine import engine
from takzero_torch.tak.state import where_state

torch.set_num_threads(2)

B, C = 16, 64


def stub_evaluator(eng):
    """The simple evaluator's logits and value, and a variance that depends
    on the position (so the backup carries a std)."""
    simple = simple_evaluator(eng)

    def evaluate(envs):
        logits, value, _ = simple(envs)
        return logits, value, 0.01 * (1 + envs.ply.float() % 5)

    return evaluate


def roots(eng, gen, b: int, plies: tuple = (2, 21), device="cpu"):
    """``b`` positions of seeded random playouts of ``plies`` plies (fewer
    where a game ends), on ``device``."""
    envs = eng.initial(b)
    stop = torch.randint(*plies, (b,), generator=gen)
    for p in range(plies[1]):
        legal = eng.legal_mask(envs)
        act = torch.multinomial(legal.float() + 1e-9, 1, generator=gen)[:, 0]
        live = (p < stop) & (eng.terminal_kind(envs) == 0)
        envs = where_state(live, eng.step(envs, act), envs)
    return envs.map(lambda x: x.to(device))


def clone(tree):
    return tree._replace(**{f: getattr(tree, f).clone() for f in tree._fields if f != "node_env"},
                         node_env=tree.node_env.map(torch.clone))


def assert_same(a, b, what: str) -> None:
    """Equal bits (so -0.0 and +0.0 apart) in every array of two trees or
    two dicts of tensors, on one device."""
    items = a._asdict().items() if hasattr(a, "_asdict") else a.items()
    other = b._asdict() if hasattr(b, "_asdict") else b
    for name, x in items:
        y = other[name]
        for u, v in (zip(x, y) if name == "node_env" else [(x, y)]):
            if u.dtype == torch.float32:
                u, v = u.view(torch.int32), v.view(torch.int32)
            assert torch.equal(u, v), f"{what}: {name}"


@functools.lru_cache(maxsize=None)
def _searched(n: int, seed: int, b: int, c: int, device: str):
    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(seed)
    tree = init_tree(eng, roots(eng, gen, b, device=device), 56, c)
    search = gumbel.make_gumbel_search(eng, stub_evaluator(eng), 8, 48)
    noise, betas = gumbel_noise(gen, (b, c)), torch.rand(b, generator=gen) * 0.5
    return eng, gen.get_state(), search(tree, noise.to(device), betas.to(device))[0]


def marked_tree(n: int, seed: int, b: int = B, c: int = C, device: str = "cpu"):
    """(engine, generator, tree): a tree after a Gumbel search (k=8, budget
    48, the stub evaluator) from random positions of 2-20 plies, then
    marked for the solver: a tenth of the valid child slots proven (win,
    loss or draw at plies 0-9), the nodes' incompleteness redrawn at one
    half, and two nodes a lane whose valid children are all proven wins.
    The draws come from the generator, on the CPU."""
    eng, state, tree = _searched(n, seed, b, c, str(device))
    tree, gen = clone(tree), torch.Generator()
    gen.set_state(state)
    dev = tree.child_visit.device
    valid = (tree.child_action >= 0).cpu()
    proven = valid & (torch.rand(valid.shape, generator=gen) < 0.1)
    flags = torch.randint(1, 4, valid.shape, generator=gen, dtype=torch.int32)
    plies = torch.randint(0, 10, valid.shape, generator=gen, dtype=torch.int32)
    tree.child_flag.copy_(torch.where(proven.to(dev), flags.to(dev), tree.child_flag))
    tree.child_ply.copy_(torch.where(proven.to(dev), plies.to(dev), tree.child_ply))
    tree.node_incomplete.copy_(torch.rand(tree.node_incomplete.shape, generator=gen) < 0.5)
    live = tree.node_live.cpu()
    live[:, 0] = True
    for lane in range(b):
        rows = live[lane].nonzero()[:, 0]
        for node in rows[torch.randperm(len(rows), generator=gen)[:2]].tolist():
            won = torch.where(valid[lane, node].to(dev), ev.WIN, tree.child_flag[lane, node])
            tree.child_flag[lane, node] = won
    return eng, gen, tree


def forced_slot(tree, gen) -> torch.Tensor:
    """A valid root slot a lane, an expanded one where the root has one, as
    the Gumbel search forces its sampled children."""
    weight = ((tree.child_action[:, 0] >= 0).float() + (tree.child_node[:, 0] >= 0).float()).cpu()
    return (weight * torch.rand(weight.shape, generator=gen)).argmax(-1).to(tree.child_visit.device)


@pytest.mark.parametrize("n,seed", [(4, 1), (6, 2)])
@pytest.mark.parametrize("forced,skip_root,depth", [(False, False, 48), (True, True, 48), (False, False, 1),
                                                    (True, True, 1)])
def test_descend_plain_equals_the_batched_loop(n, seed, forced, skip_root, depth):
    """Every output of the descent and the root's visits, with and without
    a forced slot at the root (a valid one, as the Gumbel search forces)
    and ``skip_root``, and at a depth clip."""
    eng, gen, tree = marked_tree(n, seed)
    beta = torch.rand(B, generator=gen) * 0.5
    slot = forced_slot(tree, gen) if forced else None
    phases = core.make_simulate(eng, stub_evaluator(eng), max_depth=depth).phases
    ref, plain = clone(tree), clone(tree)
    want = phases["descend"](ref, beta, slot, skip_root)
    got = descend_plain(plain, beta, slot, skip_root, depth)
    assert_same(got, want, "descent outputs")
    assert_same(plain, ref, "tree")
    if depth > 1:
        assert bool(want["stop_known"].any()) and bool(want["stop_leaf"].any())
    elif forced:
        assert bool(want["active"].any())  # a clipped lane


@pytest.mark.parametrize("n,seed", [(4, 1), (6, 2)])
@pytest.mark.parametrize("mode,skip_root", [("all", False), ("all", True), ("known", False), ("leaf", False)])
def test_backup_plain_equals_the_batched_loop(n, seed, mode, skip_root):
    """The backup of one simulation's paths (its known stops, evaluated
    leaves or both) from the same tree: every tree array, the solver's
    proofs included (``skip_root`` with a forced slot, as in the Gumbel
    search)."""
    eng, gen, tree = marked_tree(n, seed)
    evaluate = stub_evaluator(eng)
    phases = core.make_simulate(eng, evaluate, max_depth=8).phases
    slot = forced_slot(tree, gen) if skip_root else None
    rec = phases["forward"](tree, core._betas(tree, 0.25), slot, skip_root)
    logits, v_net, var_net = evaluate(rec["env_eval"])
    phases["apply_eval"](tree, rec, logits, v_net, var_net)
    ref, plain = clone(tree), clone(tree)
    phases["backward"](ref, rec, v_net, var_net, skip_root, mode)
    backup_plain(plain, rec, v_net, var_net, skip_root, mode)
    assert_same(plain, ref, "tree")
    assert not (_same_bits(ref.child_value, tree.child_value) and _same_bits(ref.root_value, tree.root_value))
    proved = (ref.child_flag != tree.child_flag) | (ref.root_flag != tree.root_flag).any()
    assert mode == "leaf" or bool(proved.any())  # the solver proved a node


def _same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n,seed", [(4, 5), (6, 6)])
def test_a_gumbel_search_walked_lane_by_lane_equals_the_loops(monkeypatch, n, seed):
    """A whole Gumbel search (k=4, budget 16) whose simulations descend and
    back up with the plain statements builds the batched loops' tree and
    chooses their slots."""
    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(seed)
    envs, noise, betas = roots(eng, gen, B), gumbel_noise(gen, (B, C)), torch.rand(B, generator=gen)

    def lanewise_make_simulate(eng, evaluator, max_depth=48, topk="auto"):
        phases = core.make_simulate(eng, evaluator, max_depth=max_depth, topk=topk).phases

        def simulate(tree, beta, forced_slot=None, *, skip_root=False):
            loop = descend_plain(tree, core._betas(tree, beta), forced_slot, skip_root, max_depth)
            rec = phases["settle"](tree, loop)
            logits, v_net, var_net = evaluator(rec["env_eval"])
            phases["apply_eval"](tree, rec, logits, v_net, var_net)
            return backup_plain(tree, rec, v_net, var_net, skip_root)

        simulate.search_scope = lambda tree: contextlib.nullcontext(simulate)
        return simulate

    out = {}
    for plain in (False, True):
        with monkeypatch.context() as m:
            if plain:
                m.setattr(gumbel, "make_simulate", lanewise_make_simulate)
            search = gumbel.make_gumbel_search(eng, stub_evaluator(eng), 4, 16)
            out[plain] = search(init_tree(eng, envs, 24, C), noise, betas)
    (tree, slot), (ref, ref_slot) = out[True], out[False]
    assert torch.equal(slot, ref_slot)
    assert_same(tree, ref, "searched tree")
