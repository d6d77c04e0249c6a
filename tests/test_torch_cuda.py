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


@pytest.mark.parametrize("a,k", [(9036, 256), (1030, 64), (300, 300)])
def test_topk_kernel_matches_plain(cuda, a, k):
    gen = torch.Generator().manual_seed(a + k)
    x = _topk_rows(128, a, gen).to(cuda)
    before = topk.exact_top_k_unsorted.launches
    vals, idx = topk.exact_top_k_unsorted(x, k)
    torch.cuda.synchronize()
    assert topk.exact_top_k_unsorted.launches == before + 1
    pv, pi = topk.topk_plain(x, k)
    assert torch.equal(idx, pi)
    assert torch.equal(vals, pv)


def test_topk_rejects_rows_too_wide_for_shared_memory(cuda):
    with pytest.raises(ValueError, match="shared memory"):
        topk.exact_top_k_unsorted(torch.zeros(2, 65216, device=cuda), 256)


@pytest.mark.parametrize("bits", [12, 26, 32])
def test_simhash_kernel_matches_plain(cuda, bits):
    gen = torch.Generator().manual_seed(bits)
    x = (torch.rand(128, 1296, generator=gen) < 0.2).float()
    m = torch.randn(1296, bits, generator=gen)
    before = simhash.simhash_pack.launches
    got = simhash.simhash_pack(x.to(cuda), m.to(cuda)).cpu()
    assert simhash.simhash_pack.launches == before + 1
    want = simhash.simhash_plain(x.to(cuda), m.to(cuda)).cpu()
    dots = x.double() @ m.double()
    sure = ((dots.abs() > 1e-4).long() << torch.arange(bits)).sum(-1)
    np.testing.assert_array_equal((got & sure).numpy(), (want & sure).numpy())
