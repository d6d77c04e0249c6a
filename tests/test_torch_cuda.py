"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` and is skipped without
them.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from takzero_torch.ops import simhash, topk

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
    before = topk.exact_top_k_unsorted.launches
    vals, idx = topk.exact_top_k_unsorted(x, k)
    torch.cuda.synchronize()
    assert topk.exact_top_k_unsorted.launches == before + 1
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
    before = simhash.simhash_pack.launches
    got = simhash.simhash_pack(x, m)
    again = simhash.simhash_pack(x, m)
    assert simhash.simhash_pack.launches == before + 2
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
        before = topk.exact_top_k_unsorted.launches
        t1 = serve(simulate(init_tree(eng, state, 256, 64), 0.0), 0.0)
        t2 = simulate_batch(simulate(init_tree(eng, state, 256, 64), 0.0), 0.0, k)
        one = t1._replace(**{f: getattr(t1, f)[:1] for f in t1._fields if f != "node_env"},
                          node_env=t1.node_env.map(lambda x: x[:1]))
        best = int(one.child_action[0, 0][one.child_visit[0, 0].argmax()])
        t3, ok = descend_device(one, best)
        assert bool(ok)
        if torch.device(dev).type == "cuda":
            assert topk.exact_top_k_unsorted.launches == before + 2 + 1 + k
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
        before = topk.exact_top_k_unsorted.launches
        out[str(dev)] = search(init_tree(eng, envs, 24, 64), gumbel.to(dev), torch.zeros(2, device=dev))
        if torch.device(dev).type == "cuda":
            assert topk.exact_top_k_unsorted.launches == before + 17
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
