"""The descent, settle and backup kernels' per-lane algorithm against the
batched loops, on the CPU.

``search/lanewise.py`` states what the kernels of ``ops/tree.py`` do: each
lane walks its own path, one level at a time, and settles its own leaf.
Here ``descend_plain``, ``settle_plain`` and ``backup_plain`` must equal the
batched operators of ``search/core.py`` (the CPU's path, which the JAX
parity tests hold) bit for bit, on trees built by real Gumbel searches with
a stub evaluator at 4x4 and 6x6 (the settle also at 5x5 and 8x8, its leaves
planted with positions that end the game in each way the rules know), then
marked with proven wins, losses and draws, incomplete nodes and nodes whose
valid children are all proven wins.  ``apply_eval_plain`` must equal the
batched ``apply_eval`` on settled planted trees with an already-expanded
leaf and a full allocator, every array bit for bit but the priors, which
it sums in the order of torch's CUDA reduction (the CPU's sums in another:
within 2 ulp); ``legal_mask_plain`` must equal the engine's mask at 3x3 to
8x8.  The card's side (the kernels equal to both) is
``tests/test_torch_cuda.py``.

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
from takzero_torch.search.lanewise import apply_eval_plain, backup_plain, descend_plain, legal_mask_plain, settle_plain
from takzero_torch.search.agents import simple_evaluator
from takzero_torch.search.tree import init_tree
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak.engine import engine
from takzero_torch.tak.moves import DEFAULT_RESERVES, ptn_to_action
from takzero_torch.tak.state import TakState, where_state

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


def position(n: int, stacks: dict, to_move: int = 0, ply: int = 10, reversible: int = 0, reserves=None) -> TakState:
    """One state (no batch dimension): ``stacks`` maps a square ("a1") to
    its stack's colours bottom to top ("1" white, "2" black) and an optional
    "S" or "C" for its top."""
    height, owner, tops = [0] * n * n, [0] * n * n, [0] * n * n
    for square, stack in stacks.items():
        q = (int(square[1:]) - 1) * n + ord(square[0]) - ord("a")
        colours = stack.rstrip("SC")
        height[q], owner[q] = len(colours), sum((int(x) - 1) << i for i, x in enumerate(colours))
        tops[q] = 3 if stack.endswith("C") else 2 if stack.endswith("S") else 1
    stones, caps = DEFAULT_RESERVES[n]
    reserves = [[stones - 8, caps], [stones - 8, caps]] if reserves is None else reserves
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return TakState(i32(height), torch.tensor(owner, dtype=torch.int64), i32(tops), i32(reserves), i32(to_move),
                    i32(ply), i32(reversible))


def planted_positions(n: int) -> list:
    """(what, state, PTN move, the terminal kind after it: 0 ongoing, 1 win
    for the side then to move, 2 loss, 3 draw) at half komi 4 and the
    reversible limit 50: each way a game ends, and the steps that reset or
    reach the reversible count."""
    last = chr(ord("a") + n - 1)
    row = lambda r, colour, files=n - 1: {f"{chr(ord('a') + c)}{r}": colour for c in range(files)}  # noqa: E731
    walls = {f"{chr(ord('a') + c)}{r}": "12"[(r + c) % 2] + "S" for r in range(1, n + 1) for c in range(n)}
    del walls["a1"]
    return [
        ("white road", position(n, row(1, "1")), f"{last}1", 2),
        ("black road, south to north", position(n, {f"a{r}": "2" for r in range(1, n)}, to_move=1, ply=11),
         f"a{n}", 2),
        ("both roads: the mover's", position(n, {**row(1, "2"), **row(2, "1"), f"{last}2": "12"}, to_move=1, ply=11),
         f"{last}2-", 2),
        ("the opponent's road", position(n, {**row(2, "2"), f"{last}2": "21"}), f"{last}2+", 1),
        ("full board, flat win", position(n, walls), "a1", 1),
        ("full board, flat draw", position(n, {**walls, "b2": "1"}), "a1", 3),
        ("empty reserve, flat win", position(n, {"a1": "1", "c1": "1", "a3": "1", "c3": "2"},
                                             reserves=[[1, 0], [10, 0]]), "b2", 2),
        ("reversible limit", position(n, {"b2": "1"}, reversible=49), "b2>", 3),
        ("a capstone crushes a wall", position(n, {"b2": "1C", "c2": "2S"}, reversible=49), "b2>", 0),
        ("a spread whose last drop crushes", position(n, {"b2": "21C", "d2": "2S"}, reversible=49), "2b2>11", 0),
        ("swap ply 0", position(n, {}, ply=0), "a1", 0),
        ("swap ply 1", position(n, {"a1": "2"}, to_move=1, ply=1), f"{last}{n}", 0),
        ("a tall stack spread one by one", position(n, {"a2": "2121212121"}), f"{n - 1}a2>" + "1" * (n - 1), 0),
    ]


def planted_tree(n: int, seed: int, depth: int, b: int = B, c: int = C, device: str = "cpu"):
    """(engine, tree, descent outputs, planted lanes, their terminal kinds):
    a marked tree whose first two roots are unexpanded (the first a
    finished game, so a terminal root), descended to ``depth`` (at depth 1
    with a forced slot, so most lanes are clipped), then each of the next
    lanes' leaf parent (the root's for a lane that stopped elsewhere)
    given a state of :func:`planted_positions` and its leaf edge the move."""
    eng, gen, tree = marked_tree(n, seed, b, c, device)
    dev = tree.child_visit.device
    won = position(n, {f"{chr(ord('a') + col)}1": "1" for col in range(n)}, to_move=1, ply=11)
    for lane in (0, 1):
        tree.child_action[lane, 0] = -1
        tree.root_flag[lane] = 0
    for pool, x in zip(tree.node_env, won):
        pool[0, 0] = x.to(dev)
    forced = forced_slot(tree, gen) if depth == 1 else None
    descend = core.make_simulate(eng, stub_evaluator(eng), max_depth=depth).phases["descend"]
    loop = descend(tree, core._betas(tree, 0.3), forced, depth == 1)
    planted, kinds = [], []
    for lane, (_, state, move, kind) in enumerate(planted_positions(n), start=2):
        node, slot = int(loop["leaf_parent"][lane]), int(loop["leaf_slot"][lane])
        for pool, x in zip(tree.node_env, state):
            pool[lane, node] = x.to(dev)
        tree.child_action[lane, node, slot] = ptn_to_action(n, move)
        planted.append(lane)
        kinds.append(kind)
    return eng, tree, loop, planted, kinds


@pytest.mark.parametrize("n,seed", [(4, 1), (5, 3), (6, 2), (8, 4)])
@pytest.mark.parametrize("depth", [48, 1])
def test_settle_plain_equals_the_batched_settle(n, seed, depth):
    """Every output of ``settle`` (the evaluated states included) and every
    tree array, on a tree with root-expanding lanes (one of them a finished
    game), depth-clipped lanes at depth 1, and leaves planted with roads
    (white's, black's, both, the opponent's), flat wins and draws on a full
    board or an empty reserve, the reversible limit, crushes and swap-ply
    placements; the batched engine gives each planted move its kind."""
    eng, tree, loop, planted, kinds = planted_tree(n, seed, depth)
    settle = core.make_simulate(eng, stub_evaluator(eng), max_depth=depth).phases["settle"]
    ref, plain = clone(tree), clone(tree)
    want = settle(ref, loop)
    got = settle_plain(plain, loop, eng, depth)
    assert_same(got["env_eval"]._asdict(), want["env_eval"]._asdict(), "evaluated states")
    assert_same({k: v for k, v in got.items() if k != "env_eval"},
                {k: v for k, v in want.items() if k != "env_eval"}, "outputs")
    assert_same(plain, ref, "tree")
    assert eng.terminal_kind(want["env_eval"])[planted].tolist() == kinds
    assert bool(want["lane_root_expand"][:2].all()) and int(ref.root_flag[0]) == 2
    if depth == 1:
        assert bool(loop["active"].any()) and int(ref.overflow.sum()) > int(tree.overflow.sum())
    else:
        terminal_leaves = loop["stop_leaf"] & ~want["lane_eval_leaf"]
        assert bool(terminal_leaves.any())


def mask_positions(n: int) -> list:
    """(what, state): the placements' and the spreads' limits of the legal
    mask, and positions of random playouts."""
    stones, caps = DEFAULT_RESERVES[n]
    tall, last = "12" * (n // 2 + 2), chr(ord("a") + n - 1)
    planted = [
        ("swap ply 0", position(n, {}, ply=0)),
        ("swap ply 1", position(n, {"a1": "2"}, to_move=1, ply=1)),
        ("no stones left", position(n, {"b2": "1", "c2": "2"}, reserves=[[0, caps], [stones, caps]])),
        ("no capstone left", position(n, {"b2": "1"}, reserves=[[stones - 3, 0], [stones, 1]])),
        ("carries at the height and n limits", position(n, {"b2": tall, "a1": "2" * n, "c3": "21"})),
        ("blocked spreads", position(n, {"b2": "21", "c2": "2S", "b3": "1C", "a2": "11", "b1": "2S"})),
        ("a capstone crushes a wall", position(n, {"b2": "1C", "c2": "2S", "b3": "2S", "a2": "1S"})),
        ("a lone capstone crushes past a flat", position(n, {"a1": "21C", "b1": "2", "c1": "1S"})),
        ("a wall at the board's edge", position(n, {f"{last}2": "1C", f"{last}3": "2S", "a1": "1C"})),
    ]
    gen = torch.Generator().manual_seed(n)
    envs = roots(engine(n), gen, 6, plies=(n, 4 * n))
    return planted + [(f"playout {i}", envs.map(lambda x: x[i])) for i in range(6)]


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_legal_mask_plain_equals_the_engine(n):
    """The mask kernel's decision, one state at a time, equals
    ``TakEngine.legal_mask``: swap plies, empty stone and capstone
    reserves, carries at the height and ``n`` limits, spreads blocked by
    walls, capstones and the edge, capstones crushing walls (alone, and
    after dropping on a flat), and random playouts."""
    eng = engine(n, half_komi=4)
    positions = mask_positions(n)
    want = eng.legal_mask(TakState(*(torch.stack(x) for x in zip(*(state for _, state in positions)))))
    for (what, state), row in zip(positions, want):
        assert torch.equal(legal_mask_plain(eng, state), row), what
    assert bool(want[:, 3 * n * n:].any())  # spreads


def expansion_case(n: int, seed: int, c: int = C, b: int = B, device="cpu"):
    """(engine, tree, settle's record, logits, value, variance): a planted
    tree (:func:`planted_tree`: root-expanding lanes, one a finished game;
    terminal and ongoing leaves) settled by ``settle``, then one evaluated
    leaf marked as already expanded (a repeated descent's) and another
    lane's allocator left full; random logits."""
    eng, tree, loop, _, _ = planted_tree(n, seed, 48, b, c, device)
    rec = core.make_simulate(eng, stub_evaluator(eng), max_depth=48).phases["settle"](tree, loop)
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, eng.num_actions, generator=gen) * 2
    v_net, var_net = torch.rand(b, generator=gen) * 2 - 1, torch.rand(b, generator=gen) * 0.1
    leaves = rec["lane_eval_leaf"].nonzero()[:, 0].tolist()
    already, full = leaves[-1], leaves[-2]
    tree.child_node[already, rec["leaf_parent"][already], rec["leaf_slot"][already]] = 1
    tree.alloc_ptr[full] = tree.free_count[full]
    return eng, tree, rec, *(x.to(device) for x in (logits, v_net, var_net))


def assert_priors_close(got: torch.Tensor, want: torch.Tensor, ulps: int, what: str) -> None:
    """Non-negative float32 arrays within ``ulps`` units in the last place."""
    gap = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(gap.max()) <= ulps, f"{what}: child_prob {int(gap.max())} ulp apart"


@pytest.mark.parametrize("n,seed,c", [(4, 1, 32), (5, 4, 32)])
def test_apply_eval_plain_equals_the_batched_apply_eval(n, seed, c):
    """Every tree array that ``apply_eval`` touches (the statistics, the
    new rows, the node pool's states, the links, the counters) bit for bit,
    the priors within 2 ulp, on lanes that expand their root, evaluate a
    leaf, evaluate nothing, find their leaf already expanded or their
    allocator full, and nodes with more legal actions than child slots and
    with fewer."""
    eng, tree, rec, logits, v_net, var_net = expansion_case(n, seed, c)
    apply_eval = core.make_simulate(eng, stub_evaluator(eng)).phases["apply_eval"]
    ref, plain = clone(tree), clone(tree)
    apply_eval(ref, rec, logits, v_net, var_net)
    apply_eval_plain(plain, rec, logits, v_net, var_net, eng, core._kernel_a)
    assert_priors_close(plain.child_prob, ref.child_prob, 2, "plain")
    assert_same(plain._replace(child_prob=ref.child_prob), ref, "tree")
    legal = eng.legal_mask(rec["env_eval"]).sum(-1)
    evaluated = rec["lane_eval_leaf"] | rec["lane_eval_root"]
    assert bool((rec["lane_root_expand"] & rec["lane_eval_root"]).any()) and bool((~evaluated).any())
    assert int(ref.overflow.sum()) == int(tree.overflow.sum()) + 1
    assert bool((legal[evaluated] > c).any()) and bool((legal[evaluated] <= c).any())
