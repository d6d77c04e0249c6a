"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` and is skipped without
them.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from takzero_torch.ops.repr import input_channels
from takzero_torch.tak.moves import action_space

from takzero_torch.ops import conv, simhash, topk
from takzero_torch.ops._build import launch_counts
from takzero_torch.search import graphs

pytestmark = pytest.mark.cuda

NEG = -3.0e38


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _topk_rows(rows: int, a: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(rows, a, generator=gen)
    q = rows // 4
    x[q:2 * q] = torch.randint(0, 4, (q, a), generator=gen).float()  # ties
    legal = torch.rand(q, a, generator=gen) < 0.01  # fewer than k legal
    x[2 * q:3 * q] = torch.where(legal, x[2 * q:3 * q], NEG)
    x[3 * q:] = 1.0  # the dummy evaluator's all-equal rows
    x[3 * q, :100] = -torch.inf
    x[3 * q + 1, 5] = torch.inf
    x[3 * q + 2, ::7] = -0.0
    x[3 * q + 3] = -torch.inf  # fewer than k finite entries
    x[3 * q + 3, 20:30] = 1.0
    return x


def _adversarial_rows(a: int, gen: torch.Generator) -> torch.Tensor:
    """Eight groups of 16 rows, each hard for a radix select."""
    x = torch.randn(128, a, generator=gen)
    rand = lambda: torch.rand(16, a, generator=gen)  # noqa: E731
    g = [slice(16 * i, 16 * (i + 1)) for i in range(8)]
    x[g[1]] = torch.randint(0, 4, (16, a), generator=gen).float()  # integer ties
    x[g[2]] = torch.where(rand() < 100 / a, x[g[2]], NEG)  # threshold at NEG, thousands of ties
    x[g[3]] = torch.where(rand() < 600 / a, x[g[3]], NEG)  # more than 256 legal
    x[g[4]] = 1.0 + rand() * 2.0 ** -12  # one 11-bit bin of many distinct keys
    x[g[5]] = torch.where(rand() < 0.5, -torch.inf, x[g[5]])
    x[g[5], ::97] = torch.inf
    u = rand()
    pick = torch.where(u < 1 / 64, 0, torch.where(u < 0.5, 1, torch.where(u < 0.9, 2, 3)))
    x[g[6]] = torch.tensor([1.0, 0.0, -0.0, -1.0])[pick]  # threshold at zero, +-0.0 mixed
    x[g[7]] = torch.where(rand() < 0.3, 1.0, NEG)  # the dummy evaluator: ties under a mask
    x[g[7]][:4] = 1.0
    return x


def _expect_topk_equal(x: torch.Tensor, k: int) -> None:
    before = launch_counts()["exact_top_k_unsorted"]
    vals, idx = topk.exact_top_k_unsorted(x, k)
    torch.cuda.synchronize()
    assert launch_counts()["exact_top_k_unsorted"] == before + 1
    pv, pi = topk.topk_plain(x, k)
    assert torch.equal(idx, pi)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))  # -0.0 and +0.0 apart


@pytest.mark.parametrize("a,k", [(9036, 256), (1030, 64), (300, 300)])
def test_topk_kernel_matches_plain(cuda, a, k):
    gen = torch.Generator().manual_seed(a + k)
    _expect_topk_equal(_topk_rows(128, a, gen).to(cuda), k)


@pytest.mark.parametrize("k", [1, 256, None])
@pytest.mark.parametrize("a", [9036, 24843])
def test_topk_kernel_adversarial_rows(cuda, a, k):
    gen = torch.Generator().manual_seed(a)
    _expect_topk_equal(_adversarial_rows(a, gen).to(cuda), a if k is None else k)


@pytest.mark.parametrize("k", [1, 256, None])
@pytest.mark.parametrize("rows", ["random", "adversarial"])
def test_topk_kernel_rows_wider_than_shared_memory(cuda, rows, k):
    """8x8 rows (A = 65216) take the kernel that keeps the row in device
    memory; values bit for bit and indices exactly as the plain version."""
    a = 65216
    gen = torch.Generator().manual_seed(a + (k or 0))
    x = _topk_rows(128, a, gen) if rows == "random" else _adversarial_rows(a, gen)
    _expect_topk_equal(x.to(cuda), a if k is None else k)


def _expect_simhash_equal(x: torch.Tensor, m: torch.Tensor) -> None:
    bits = m.shape[1]
    before = launch_counts()["simhash_pack"]
    got = simhash.simhash_pack(x, m)
    again = simhash.simhash_pack(x, m)
    assert launch_counts()["simhash_pack"] == before + 2
    assert got.dtype == torch.int64 and torch.equal(got, again)
    want = simhash.simhash_plain(x, m).cpu()
    got = got.cpu()
    dots = x.cpu().double() @ m.cpu().double()
    sure = ((dots.abs() > 1e-4).long() << torch.arange(bits)).sum(-1)
    np.testing.assert_array_equal((got & sure).numpy(), (want & sure).numpy())
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** bits


@pytest.mark.parametrize("bits", [12, 26, 32])
def test_simhash_kernel_matches_plain(cuda, bits):
    gen = torch.Generator().manual_seed(bits)
    x = (torch.rand(128, 1296, generator=gen) < 0.2).float()
    m = torch.randn(1296, bits, generator=gen)
    _expect_simhash_equal(x.to(cuda), m.to(cuda))


@pytest.mark.parametrize(
    "b,inp,bits",
    [(128, 1296, 1), (1, 1296, 32), (37, 1001, 26), (5, 20, 7), (130, 2816, 32)],
)
def test_simhash_kernel_ragged_shapes(cuda, b, inp, bits):
    """B and In that are not multiples of the kernel's tiles, B=1, 1 bit."""
    gen = torch.Generator().manual_seed(b * inp + bits)
    x = (torch.rand(b, inp, generator=gen) < 0.2).float()
    x[:, -(inp // 10):] = torch.rand(b, inp // 10, generator=gen)
    m = torch.randn(inp, bits, generator=gen)
    _expect_simhash_equal(x.to(cuda), m.to(cuda))


TREE_FLOATS = ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")


def _trees_equal(a, b, where: str, tol: float | None = None) -> None:
    """Every tree array of ``a`` (card) equal to ``b`` (CPU) outside the
    scratch row, where duplicate stores land in an unfixed order; with
    ``tol``, the float arrays of TREE_FLOATS within it."""
    for name, x in a._asdict().items():
        y = getattr(b, name)
        for u, v in (zip(x, y) if name == "node_env" else [(x, y)]):
            u = u.cpu()
            if u.dim() >= 2 and name != "free_rows":
                u, v = u[:, :-1], v[:, :-1]
            if tol is not None and name in TREE_FLOATS:
                torch.testing.assert_close(u, v, rtol=tol, atol=tol, msg=lambda m: f"{where}: {name}: {m}")
            else:
                assert torch.equal(u, v), f"{where}: {name}"


@pytest.mark.parametrize("n,moves,k", [(3, ("a3", "c1"), 15), (5, ("a5", "e1"), 31), (6, ("a1", "f6"), 127)])
def test_serve_chunk_and_simulate_batch_card_equals_cpu(cuda, n, moves, k):
    """The wavefront serve chunk, ``simulate_batch`` and ``descend_device``
    on the card give the CPU's trees exactly (dummy evaluator: all logits
    equal, values 0), through kernel A on the card."""
    from takzero_torch.search.agents import dummy_evaluator
    from takzero_torch.search.core import make_kernels
    from takzero_torch.search.serve import make_serve_chunk
    from takzero_torch.search.tree import descend_device, init_tree
    from takzero_torch.tak import engine, ptn_to_action

    eng = engine(n)
    out = {}
    for dev in ("cpu", cuda):
        ev = dummy_evaluator(eng)
        simulate, simulate_batch = make_kernels(eng, ev, max_depth=16)
        serve = make_serve_chunk(eng, ev, k, max_depth=16)
        state = eng.initial(2, dev)
        for mv in moves:
            state = eng.step(state, torch.full((2,), ptn_to_action(n, mv), device=dev))
        before = launch_counts()["exact_top_k_unsorted"]
        t1 = serve(simulate(init_tree(eng, state, 256, 64), 0.0), 0.0)
        t2 = simulate_batch(simulate(init_tree(eng, state, 256, 64), 0.0), 0.0, k)
        one = t1._replace(**{f: getattr(t1, f)[:1] for f in t1._fields if f != "node_env"},
                          node_env=t1.node_env.map(lambda x: x[:1]))
        best = int(one.child_action[0, 0][one.child_visit[0, 0].argmax()])
        t3, ok = descend_device(one, best)
        assert bool(ok)
        if torch.device(dev).type == "cuda":
            assert launch_counts()["exact_top_k_unsorted"] == before + 2 + 1 + k
        out[str(dev)] = (t1, t2, t3)
    for what, a, b in zip(("serve chunk", "simulate_batch", "descend_device"), out[str(cuda)], out["cpu"]):
        _trees_equal(a, b, what)


def test_gumbel_search_8x8_card_equals_cpu(cuda):
    """An 8x8 search (8 filters, 1 block, float32, no novelty; 2 games, k=4,
    budget 16, 24 rows, C=64) on the card against the CPU: kernel A's
    wide-row path in every expansion; integer tree arrays equal, floats
    within 1e-4 (the convolutions sum in another order on the card)."""
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.search.gumbel import make_gumbel_search
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.search.tree import init_tree
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak import engine

    eng = engine(8, half_komi=4)
    cfg = NetConfig(n=8, half_komi=4, filters=8, blocks=1, novelty="none", compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(8)
    sym, pair = torch.randint(0, 8, (2,), generator=gen), torch.randint(0, 2, (2,), generator=gen)
    gumbel = gumbel_noise(gen, (2, 64))
    out = {}
    for dev in ("cpu", cuda):
        agent = new_agent(cfg, seed=0, device=dev)
        evaluate = make_net_evaluate(cfg, eng, device=dev)
        envs = make_new_opening(eng)(sym.to(dev), pair.to(dev))
        search = make_gumbel_search(eng, lambda e: evaluate(agent, e), 4, 16, max_depth=16)
        before = launch_counts()["exact_top_k_unsorted"]
        out[str(dev)] = search(init_tree(eng, envs, 24, 64), gumbel.to(dev), torch.zeros(2, device=dev))
        if torch.device(dev).type == "cuda":
            assert launch_counts()["exact_top_k_unsorted"] == before + 17
    (tc, sc), (tp, sp) = out[str(cuda)], out["cpu"]
    assert torch.equal(sc.cpu(), sp)
    _trees_equal(tc, tp, "8x8 search", tol=1e-4)


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_planes_and_lcghash_card_equal_cpu(cuda, n):
    """The input planes bit for bit on the card and the CPU (the LCG hash
    reads their bits), and so the LCG hash indices."""
    from takzero_torch.models.agent import lcghash_indices
    from takzero_torch.models.network import NetConfig
    from takzero_torch.ops.repr import input_channels, state_to_planes
    from takzero_torch.tak.engine import engine
    from takzero_torch.tak.state import where_state

    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(n)
    envs = eng.initial(256)
    for _ in range(3 * n * n):  # random games of every length, reserves spent
        legal = eng.legal_mask(envs)
        act = torch.multinomial(legal.float() + 1e-9, 1, generator=gen)[:, 0]
        live = (eng.terminal_kind(envs) == 0) & (torch.rand(256, generator=gen) < 0.9)
        envs = where_state(live, eng.step(envs, act), envs)
    want = state_to_planes(eng, envs)
    got = state_to_planes(eng, envs.map(lambda t: t.to(cuda)))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    cfg = NetConfig(n=n, novelty="lcghash", hash_bits=32)
    scale = torch.randn(input_channels(n), n, n, generator=gen)
    assert torch.equal(lcghash_indices(cfg, scale.to(cuda), got).cpu(), lcghash_indices(cfg, scale, want))


def test_simhash_kernel_at_seen_ratio_rows(cuda):
    """Kernel B at seen-ratio's shape, 65,536 rows of random 6x6 positions'
    planes (side to move zeroed) times M f32[1296, 32]; and at EEE
    generalization's [256, 448] x [448, 26]."""
    from takzero_torch.eee.harness import random_plane_batch
    from takzero_torch.models.network import NetConfig, simhash_matrix
    from takzero_torch.ops.repr import input_channels
    from takzero_torch.tak.engine import engine

    for n, rows, bits, ply in ((6, 65_536, 32, 12), (4, 256, 26, 6)):
        planes = random_plane_batch(engine(n, half_komi=4), torch.Generator(cuda).manual_seed(n), ply, rows)
        planes[:, input_channels(n) - 2] = 0.0
        m = simhash_matrix(NetConfig(n=n, hash_bits=bits), seed=1).to(cuda)
        _expect_simhash_equal(planes.reshape(rows, -1).contiguous(), m)


@pytest.mark.parametrize("k", [1, 64, 944])
def test_topk_kernel_at_one_4x4_tree(cuda, k):
    """Kernel A at visualize_search's single tree, f32[1, 944]: masked
    logits and an adversarial row."""
    gen = torch.Generator().manual_seed(k)
    masked = torch.where(torch.rand(1, 944, generator=gen) < 0.2, torch.randn(1, 944, generator=gen), NEG)
    _expect_topk_equal(masked.contiguous().to(cuda), k)
    for row in (2, 4, 6):
        _expect_topk_equal(_adversarial_rows(944, gen)[16 * row : 16 * row + 1].contiguous().to(cuda), k)


def _with_loops(monkeypatch, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the search's batched loops in place of
    the descent and backup kernels."""
    from takzero_torch.search import core

    with monkeypatch.context() as m:
        m.setattr(core, "_tree_kernels", lambda tree: False)
        return fn(*args, **kwargs)


def _outputs_equal(got: dict, want: dict, where: str) -> None:
    for name, x in want.items():
        u, v = got[name], x
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v), f"{where}: {name}"


@pytest.mark.parametrize("n,c", [(6, 256), (5, 128)])
def test_tree_kernels_equal_the_plain_walks_and_the_loops(cuda, monkeypatch, n, c):
    """The descent and backup kernels at C=256 (6x6) and C=128 (5x5), 32
    lanes, on a searched tree marked for the solver (proven wins, losses
    and draws, incomplete nodes, nodes of proven-win children only): every
    output and tree array bit for bit equal to the per-lane plain
    statements and to the batched loops, with and without a forced slot
    and ``skip_root``, at depth clips, and in the backup's three modes."""
    from takzero_torch.search import core
    from takzero_torch.search.lanewise import backup_plain, descend_plain
    from test_torch_lanewise import clone, forced_slot, marked_tree, stub_evaluator

    b = 32
    eng, gen, tree = _with_loops(monkeypatch, marked_tree, n, n, b, c, cuda)
    for forced, skip_root, depth in ((False, False, 48), (True, True, 48), (False, False, 1), (True, True, 1)):
        where = f"descent forced={forced} skip_root={skip_root} depth={depth}"
        beta = (torch.rand(b, generator=gen) * 0.5).to(cuda)
        slot = forced_slot(tree, gen) if forced else None
        descend = core.make_simulate(eng, stub_evaluator(eng), max_depth=depth).phases["descend"]
        kern, loop, plain = clone(tree), clone(tree), clone(tree)
        before = launch_counts()["tree_descend"]
        got = descend(kern, beta, slot, skip_root)
        assert launch_counts()["tree_descend"] == before + 1
        want = _with_loops(monkeypatch, descend, loop, beta, slot, skip_root)
        lane = descend_plain(plain, beta, slot, skip_root, depth)
        torch.cuda.synchronize()
        _outputs_equal(got, want, where)
        _outputs_equal(lane, want, where + " (plain)")
        _trees_equal(kern, _on_cpu(loop), where)
        _trees_equal(plain, _on_cpu(loop), where + " (plain)")
    evaluate = stub_evaluator(eng)
    phases = core.make_simulate(eng, evaluate, max_depth=8).phases
    for mode, skip_root in (("all", False), ("all", True), ("known", False), ("leaf", False)):
        where = f"backup mode={mode} skip_root={skip_root}"
        base = clone(tree)
        slot = forced_slot(base, gen) if skip_root else None
        rec = _with_loops(monkeypatch, phases["forward"], base, core._betas(base, 0.25), slot, skip_root)
        logits, v_net, var_net = evaluate(rec["env_eval"])
        phases["apply_eval"](base, rec, logits, v_net, var_net)
        kern, loop, plain = clone(base), clone(base), clone(base)
        before = launch_counts()["tree_backup"]
        phases["backward"](kern, rec, v_net, var_net, skip_root, mode)
        assert launch_counts()["tree_backup"] == before + 1
        _with_loops(monkeypatch, phases["backward"], loop, rec, v_net, var_net, skip_root, mode)
        backup_plain(plain, rec, v_net, var_net, skip_root, mode)
        torch.cuda.synchronize()
        _trees_equal(kern, _on_cpu(loop), where)
        _trees_equal(plain, _on_cpu(loop), where + " (plain)")
        assert not torch.equal(loop.root_value, base.root_value) or not torch.equal(loop.child_value, base.child_value)


@pytest.mark.parametrize("n,c", [(6, 256), (5, 128), (4, 64), (8, 64)])
def test_settle_kernel_equals_the_batched_settle_and_the_plain(cuda, monkeypatch, n, c):
    """The settle kernel at 32 lanes on a searched tree whose leaves are
    planted with every way a game ends (``planted_tree``: roads, flat wins
    and draws, the reversible limit, crushes, swap-ply placements; a
    terminal and an ongoing root to expand; depth-clipped lanes at depth
    1): every output, the evaluated states included, and every tree array,
    the scratch row too, bit for bit equal to the batched ``settle`` on the
    card and to ``settle_plain``, on every lane; one launch a call."""
    from takzero_torch.search import core
    from takzero_torch.search.lanewise import settle_plain
    from test_torch_lanewise import assert_same, clone, planted_tree, stub_evaluator

    for depth in (48, 1):
        where = f"settle {n}x{n} depth={depth}"
        eng, tree, loop, planted, kinds = _with_loops(monkeypatch, planted_tree, n, 2 * n, depth, 32, c, cuda)
        settle = core.make_simulate(eng, stub_evaluator(eng), max_depth=depth).phases["settle"]
        kern, ref, plain = clone(tree), clone(tree), clone(tree)
        before = launch_counts()["tree_settle"]
        got = settle(kern, loop)
        assert launch_counts()["tree_settle"] == before + 1
        want = _with_loops(monkeypatch, settle, ref, loop)
        lane = settle_plain(plain, loop, eng, depth)
        torch.cuda.synchronize()
        assert eng.terminal_kind(want["env_eval"])[planted].tolist() == kinds, where
        for out, name in ((got, where), (lane, where + " (plain)")):
            assert_same(_on_cpu_dict(out["env_eval"]._asdict()), _on_cpu_dict(want["env_eval"]._asdict()),
                        name + ": evaluated states")
            assert_same(_on_cpu_dict({k: v for k, v in out.items() if k != "env_eval"}),
                        _on_cpu_dict({k: v for k, v in want.items() if k != "env_eval"}), name + ": outputs")
        assert_same(_on_cpu(kern), _on_cpu(ref), where + ": tree")
        assert_same(_on_cpu(plain), _on_cpu(ref), where + " (plain): tree")


@pytest.mark.parametrize("n,c,seed", [(6, 256, 12), (5, 128, 10), (4, 64, 8), (8, 64, 4)])
def test_expansion_kernels_equal_the_plain_and_the_batched_apply_eval(cuda, monkeypatch, n, c, seed):
    """The mask and store kernels around kernel A at 32 lanes on a settled
    planted tree (``expansion_case``: lanes that expand their root,
    evaluate a leaf, evaluate nothing, find their leaf already expanded or
    their allocator full), from float32, bf16 and row-broadcast logits:
    every tree array, the priors and the scratch row included, bit for bit
    equal to ``apply_eval_plain`` and to the batched ``apply_eval`` on the
    card; one launch of each a call."""
    from takzero_torch.search import core
    from takzero_torch.search.lanewise import apply_eval_plain
    from test_torch_lanewise import assert_same, clone, expansion_case, stub_evaluator

    eng, tree, rec, logits, v_net, var_net = _with_loops(monkeypatch, expansion_case, n, seed, c, 32, cuda)
    apply_eval = core.make_simulate(eng, stub_evaluator(eng)).phases["apply_eval"]
    for kind, x in (("float32", logits), ("bf16", logits.to(torch.bfloat16)),
                    ("broadcast", logits[:1].expand_as(logits))):
        where = f"expansion {n}x{n} C={c}, {kind} logits"
        kern, ref, plain = clone(tree), clone(tree), clone(tree)
        before = launch_counts()
        apply_eval(kern, rec, x, v_net, var_net)
        assert {k: launch_counts()[k] - before[k] for k in ("expand_mask", "expand_store")} == \
            {"expand_mask": 1, "expand_store": 1}, where
        with monkeypatch.context() as m:
            m.setattr(core, "_settle_kernel", lambda tree, eng: False)
            apply_eval(ref, rec, x, v_net, var_net)
        apply_eval_plain(plain, rec, x, v_net, var_net, eng, core._kernel_a)
        torch.cuda.synchronize()
        assert_same(_on_cpu(kern), _on_cpu(ref), where)
        assert_same(_on_cpu(plain), _on_cpu(ref), where + " (plain)")
    assert int(ref.overflow.sum()) > int(tree.overflow.sum())
    assert bool(ref.node_incomplete.any()) and not bool(ref.node_incomplete.all())


@pytest.mark.parametrize("n,c", [(6, 256), (5, 128)])
def test_gumbel_search_with_the_settle_kernel_equals_the_batched_settle(cuda, monkeypatch, n, c):
    """Whole graphed Gumbel searches (32 games from positions 30-69 plies
    into random playouts, k=16, budget 64, the simple evaluator) with the
    settle kernel and the expansion kernels leave every tree array and
    chosen slot equal to the same searches with ``settle`` and
    ``apply_eval`` held to their batched operators, whose descent and
    backup are still the kernels; each of the three kernels launches once a
    simulation, graph replays included, and not at all when held."""
    from takzero_torch.search import core
    from takzero_torch.search.agents import simple_evaluator
    from takzero_torch.search.gumbel import make_gumbel_search
    from takzero_torch.search.tree import init_tree
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak import engine
    from test_torch_lanewise import roots

    b, k, budget = 32, 16, 64
    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(10 + n)
    envs = roots(eng, gen, b, plies=(30, 70), device=cuda)
    gumbel, betas = gumbel_noise(gen, (b, c)).to(cuda), (torch.rand(b, generator=gen) * 0.5).to(cuda)
    search = make_gumbel_search(eng, simple_evaluator(eng), k, budget, max_depth=48)
    out = {}
    for kernel in (True, False):
        with monkeypatch.context() as m:
            if not kernel:
                m.setattr(core, "_settle_kernel", lambda tree, eng: False)
            before = launch_counts()
            tree, slot = search(init_tree(eng, envs, budget + 8, c), gumbel, betas)
            torch.cuda.synchronize()
            counts = {name: launch_counts()[name] - before[name]
                      for name in ("tree_descend", "tree_settle", "expand_mask", "expand_store")}
        held = budget + 1 if kernel else 0
        assert counts == {"tree_descend": budget + 1, "tree_settle": held, "expand_mask": held, "expand_store": held}
        out[kernel] = tree, slot
    (tree, slot), (ref, ref_slot) = out[True], out[False]
    assert torch.equal(slot, ref_slot)
    _trees_equal(tree, _on_cpu(ref), "search with the settle kernel")
    assert bool((ref.child_flag != 0).any())  # the searches found terminal leaves


@pytest.mark.parametrize("n,c", [(6, 256), (5, 128)])
def test_simulate_batch_kernels_equal_the_loops(cuda, monkeypatch, n, c):
    """``simulate_batch`` (K = 8 descents with their known stops backed up
    at once, one evaluator call, K leaf backups: the backup kernel in modes
    "known" and "leaf") on the card gives the batched loops' trees."""
    from takzero_torch.search import core
    from takzero_torch.search.tree import init_tree
    from takzero_torch.tak import engine
    from test_torch_lanewise import clone, roots, stub_evaluator

    eng = engine(n, half_komi=4)
    gen = torch.Generator().manual_seed(n)
    simulate, simulate_batch = core.make_kernels(eng, stub_evaluator(eng), max_depth=16)
    start = _with_loops(monkeypatch, simulate, init_tree(eng, roots(eng, gen, 32, device=cuda), 96, c), 0.25)
    kern, loop = clone(start), clone(start)
    for _ in range(3):
        simulate_batch(kern, 0.25, 8)
        _with_loops(monkeypatch, simulate_batch, loop, 0.25, 8)
    torch.cuda.synchronize()
    _trees_equal(kern, _on_cpu(loop), "simulate_batch")


@pytest.mark.parametrize("evaluator", ["net", "simple"])
@pytest.mark.parametrize("n,novelty", [(6, "simhash"), (5, "rnd")])
def test_graphed_gumbel_search_equals_eager(cuda, monkeypatch, n, novelty, evaluator):
    """A Gumbel search on the card runs its simulations' phases (the
    descent kernel with the forward tail, the evaluator, ``apply_eval``,
    the backup kernel) from CUDA graphs, and after each simulation every
    tree array equals what the batched torch loops, run eagerly from the
    same tree, make of it, at net6's and net5's board sizes and child slots,
    C=256 and C=128 (32 games, k=16, budget 64; a 32x2 bf16 net with SimHash over a half-set
    2^20 seen-set, or the MLP RND; or the simple evaluator, which runs
    eagerly between the graphs).  The counters of kernels A and B and of
    the five tree kernels read one launch a simulation (B's with the SimHash
    net), the convolution kernel's 2 blocks + 2 (with the net, whose kernel
    launches are inside the captured evaluator); the search engages 1
    eager, 1 captured and budget - 1 replayed simulations; and its graphs
    leave no memory allocated when it returns."""
    import contextlib

    from test_torch_lanewise import clone

    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.search import core
    from takzero_torch.search.agents import simple_evaluator
    from takzero_torch.search import gumbel as gumbel_module
    from takzero_torch.search.gumbel import make_gumbel_search
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.search.tree import init_tree
    from takzero_torch.selfplay import gumbel_noise
    from takzero_torch.tak import engine

    b, k, budget, c = 32, 16, 64, 256 if n == 6 else 128
    eng = engine(n, half_komi=4)
    cfg = NetConfig(n=n, half_komi=4, filters=32, blocks=2, novelty=novelty, hash_bits=20, rnd_mlp=True)
    gen = torch.Generator().manual_seed(n)
    envs = make_new_opening(eng)(torch.randint(0, 8, (b,), generator=gen).to(cuda),
                                 torch.randint(0, 2, (b,), generator=gen).to(cuda))
    gumbel = gumbel_noise(gen, (b, c)).to(cuda)
    betas = (torch.rand(b, generator=gen) * 0.5).to(cuda)
    agent = new_agent(cfg, seed=3, device=cuda)
    if novelty == "simhash":
        agent["hash_bits"].copy_(torch.randint(-2**31, 2**31 - 1, agent["hash_bits"].shape, generator=gen,
                                               dtype=torch.int32).to(cuda))
    if evaluator == "net":
        evaluate = core.with_agent(make_net_evaluate(cfg, eng, device=cuda), agent)
        assert evaluate.capturable
    else:
        evaluate = simple_evaluator(eng)
    search = make_gumbel_search(eng, evaluate, k, budget, max_depth=48)

    def run():
        launches = launch_counts()
        middles = dict(graphs.MIDDLES)
        tree, slot = search(init_tree(eng, envs, budget + 8, c), gumbel, betas)
        torch.cuda.synchronize()
        names = ("exact_top_k_unsorted", "simhash_pack", "tree_descend", "tree_settle", "expand_mask", "expand_store",
                 "tree_backup", "conv3x3")
        return tree, slot, [launch_counts()[k] - launches[k] for k in names], \
            {key: graphs.MIDDLES[key] - middles[key] for key in middles}

    run()  # the process's first graphed search also opens the capture pool
    level = torch.cuda.memory_allocated(cuda)
    tree, slot, launches, middles = run()
    del tree, slot
    assert torch.cuda.memory_allocated(cuda) == level
    graphed = run()
    net = evaluator == "net"  # whose convolutions are the kernel's, 2 blocks + 2 an evaluation
    assert launches == [budget + 1, budget + 1 if novelty == "simhash" and net else 0, budget + 1, budget + 1,
                        budget + 1, budget + 1, budget + 1, (2 * cfg.blocks + 2) * (budget + 1) if net else 0]
    assert middles == {"eager": 1, "captured": 1, "replayed": budget - 1}

    checked = []

    def stepwise(eng_, evaluator_, max_depth=48, topk="auto"):
        """``make_simulate`` whose searches check each graphed simulation
        against the loops run from a copy of the tree it starts from."""
        simulate = core.make_simulate(eng_, evaluator_, max_depth=max_depth, topk=topk)
        graphed_scope = simulate.search_scope

        @contextlib.contextmanager
        def scope(tree):
            with graphed_scope(tree) as sim:
                def checked_sim(t, beta, forced_slot=None, *, skip_root=False):
                    ref = clone(t)
                    _with_loops(monkeypatch, simulate, ref, beta, forced_slot, skip_root=skip_root)
                    sim(t, beta, forced_slot, skip_root=skip_root)
                    torch.cuda.synchronize()
                    _trees_equal(t, _on_cpu(ref), f"simulation {len(checked)}")
                    checked.append(True)
                    return t

                yield checked_sim

        simulate.search_scope = scope
        return simulate

    with monkeypatch.context() as m:
        m.setattr(gumbel_module, "make_simulate", stepwise)
        stepped = make_gumbel_search(eng, evaluate, k, budget, max_depth=48)(init_tree(eng, envs, budget + 8, c),
                                                                           gumbel, betas)
    assert len(checked) == budget + 1
    assert torch.equal(graphed[1], stepped[1])
    _trees_equal(graphed[0], _on_cpu(stepped[0]), "graphed search")


def test_a_search_scope_refuses_a_simulation_unlike_its_graphs(cuda):
    """A search scope's graphs fix ``skip_root`` and whether a slot is
    forced as their capture found them: the first simulation runs eagerly
    whatever it is, the second captures, the third replays, and a later
    one unlike them raises rather than replay graphs built for another."""
    from takzero_torch.search import core
    from takzero_torch.search.agents import simple_evaluator
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.search.tree import init_tree
    from takzero_torch.tak import engine

    b, c = 8, 64
    eng = engine(4, half_komi=4)
    gen = torch.Generator().manual_seed(4)
    envs = make_new_opening(eng)(torch.randint(0, 8, (b,), generator=gen).to(cuda),
                                 torch.randint(0, 2, (b,), generator=gen).to(cuda))
    simulate = core.make_simulate(eng, simple_evaluator(eng), max_depth=8)
    tree = init_tree(eng, envs, 16, c)
    before = dict(graphs.MIDDLES)
    with simulate.search_scope(tree) as sim:
        sim(tree, 0.0)  # expands the roots
        slot = (tree.child_action[:, 0] >= 0).int().argmax(-1)
        sim(tree, 0.0, slot, skip_root=True)
        sim(tree, 0.0, slot, skip_root=True)
        with pytest.raises(ValueError, match="captured with"):
            sim(tree, 0.0)
        with pytest.raises(ValueError, match="captured with"):
            sim(tree, 0.0, slot, skip_root=False)
    assert {key: graphs.MIDDLES[key] - before[key] for key in before} == {"eager": 1, "captured": 1, "replayed": 1}


def _on_cpu_dict(d: dict) -> dict:
    return {k: v.cpu() for k, v in d.items()}


def _on_cpu(tree):
    return tree._replace(**{f: getattr(tree, f).cpu() for f in tree._fields if f != "node_env"},
                         node_env=tree.node_env.map(lambda x: x.cpu()))


def _conv_layer(gen, cin, cout, dev, split=None):
    w = torch.randn(cout, cin, 3, 3, generator=gen) / (3 * cin ** 0.5)
    layer = conv._layer(w, torch.randn(cout, generator=gen) * 0.1, split=split)
    return conv.ConvLayer(layer.weight.to(dev), layer.bias.to(dev), layer.cin, layer.cout, layer.split)


def _float64_conv(x_nchw: torch.Tensor, layer) -> tuple:
    """(the layer's float64 convolution plus bias, sum |x * w|) of NCHW x."""
    w = conv.unpack_weight(layer.weight).double()
    x = torch.nn.functional.pad(x_nchw.double(), (0, 0, 0, 0, 0, w.shape[1] - x_nchw.shape[1]))
    acc = torch.nn.functional.conv2d(x, w, padding=1) + layer.bias.double()[None, :, None, None]
    return acc, torch.nn.functional.conv2d(x.abs(), w.abs(), padding=1)


@pytest.mark.parametrize("b,n,c", [
    (128, 6, 256), (128, 5, 256),  # the selfplay cells' towers: 128 x 128 and 64 x 128 tiles
    (1, 6, 256), (2, 6, 256),  # serve's small batches
    (7, 6, 256),  # a ragged batch: the last row tile is partly past M
    (128, 4, 64),  # 4x4 at 64 filters: 64 x 64 tiles
    (128, 8, 256),  # 8x8
    (64, 6, 256),  # a world-2 rank's rows
])
def test_conv_kernel_matches_plain_and_float64(cuda, b, n, c):
    """A tower layer with its residual, on the tile the launch takes: the
    float32 sum (the head launch's unrounded output) within 1e-5 of
    sum |x * w| of float64 and the same on a second launch, and the bf16
    output within one rounding of the plain version (both sum exact bf16
    products in float32, in other orders); the stem and the head (policy
    and the two 1x1 maps) against the plain version."""
    gen = torch.Generator().manual_seed(b * n + c)
    x = torch.randn(b, n, n, c, generator=gen).to(torch.bfloat16).to(cuda)
    res = torch.randn(b, n, n, c, generator=gen).to(torch.bfloat16).to(cuda)
    layer = _conv_layer(gen, c, c, cuda)
    raw = conv.ConvLayer(layer.weight, layer.bias, c, c, split=c)  # f32 out, no relu
    want, scale = _float64_conv(x.permute(0, 3, 1, 2), layer)
    plain = conv.conv3x3_plain(x, layer, res).float()
    bound = (scale + res.permute(0, 3, 1, 2).double().abs()).permute(0, 2, 3, 1).float()
    before = launch_counts()["conv3x3"]
    got = conv.conv3x3(x, layer, res).float()
    acc, _ = conv.conv3x3(x, raw)
    again, _ = conv.conv3x3(x, raw)
    torch.cuda.synchronize()
    assert launch_counts()["conv3x3"] == before + 3
    assert torch.equal(acc, again)  # no atomics: the same sums on every launch
    err = (acc.view(b, c, n, n).double() - want).abs() / scale.clamp(min=1e-30)
    assert float(err.max()) <= 1e-5
    ulp = torch.maximum(plain.abs(), got.abs()) * 2.0 ** -7 + 2e-5 * bound
    assert bool(((got - plain).abs() <= ulp).all())
    planes = torch.randint(0, 2, (b, input_channels(n), n, n), generator=gen).float().to(cuda)
    stem = _conv_layer(gen, input_channels(n), c, cuda)
    core = conv.conv3x3(planes, stem)
    want_core = conv.conv3x3_plain(planes, stem).float()
    assert bool(((core.float() - want_core).abs() <= want_core.abs() * 2.0 ** -7 + 1e-4).all())
    a = action_space(n).num_channels
    head = _conv_layer(gen, c, a + 2, cuda, split=a)
    for got, want in zip(conv.conv3x3(core, head), conv.conv3x3_plain(core, head)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,filters", [(6, 256), (5, 64), (3, 16)])
def test_bf16_apply_folded_card_equals_cpu(cuda, n, filters):
    """The whole bf16 folded path on the card (the kernel, 2 blocks + 2
    launches) against the CPU's present path, bit for bit on a fold of
    small integers (every float32 sum exact in any order); the value within
    one float32 rounding (tanh is another implementation on the card)."""
    from test_torch_conv import _integer_fold, _ints

    from takzero_torch.models import network

    cfg = network.NetConfig(n=n, filters=filters, blocks=2)
    gen = torch.Generator().manual_seed(n)
    fw = _integer_fold(cfg, gen)
    planes = _ints(gen, (9, input_channels(n), n, n), 0, 2)
    want = network.apply_folded(cfg, fw, planes, with_core=True)
    fw_card = {k: v for k, v in fw.items() if k != "packed"}
    fw_card = {k: (tuple(t.to(cuda) for t in v) if isinstance(v, tuple) else
                   [tuple(tuple(t.to(cuda) for t in conv_) for conv_ in pair) for pair in v])
               for k, v in fw_card.items()}
    before = launch_counts()["conv3x3"]
    got = network.apply_folded(cfg, fw_card, planes.to(cuda), with_core=True)
    torch.cuda.synchronize()
    assert launch_counts()["conv3x3"] == before + 2 * cfg.blocks + 2
    for g, w, what in zip(got, want, ("policy", "value", "ube", "core")):
        if what == "value":
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(g.cpu(), w), what


@pytest.mark.parametrize("net,launches", [("net6_simhash", 34), ("net5", 42)])
def test_evaluator_launches_the_kernel_per_convolution(cuda, net, launches):
    """``make_net_evaluate`` at the selfplay cells' widths and 128 rows:
    one kernel launch a convolution, ``2 blocks + 2`` an evaluation."""
    from takzero_torch.config import NET_PRESETS
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.search.openings import make_new_opening
    from takzero_torch.tak import engine

    cfg = NET_PRESETS[net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    agent = new_agent(cfg, seed=0, device=cuda)
    assert "packed" in agent["folded"]
    gen = torch.Generator().manual_seed(0)
    envs = make_new_opening(eng)(torch.randint(0, 8, (128,), generator=gen).to(cuda),
                                 torch.randint(0, 2, (128,), generator=gen).to(cuda))
    evaluate = make_net_evaluate(cfg, eng, device=cuda)
    before = launch_counts()["conv3x3"]
    logits, value, variance = evaluate(agent, envs)
    torch.cuda.synchronize()
    assert launch_counts()["conv3x3"] - before == launches
    assert logits.shape == (128, cfg.num_actions) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(value).all()) and bool(torch.isfinite(variance).all())
