"""The plain versions of the port's two kernels against the Pallas kernels.

* ``topk_plain`` (kernel A's plain version) must equal
  ``exact_top_k_unsorted(..., interpret=True)`` and
  ``exact_top_k_unsorted_reference`` exactly, values and indices, on normal,
  integer-tie, masked, ``-inf`` and all-equal rows.
* ``simhash_plain`` (kernel B's plain version) must equal
  ``simhash_pack(..., interpret=True)`` on every bit whose float64 dot
  product satisfies ``|dot| > 1e-4``: the frameworks sum in different
  orders, which can flip the sign of a dot that is within rounding of 0.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.ops.pallas_kernels import simhash_pack, simhash_pack_reference
from takzero_tpu.ops.topk import exact_top_k_unsorted as pallas_topk
from takzero_tpu.ops.topk import exact_top_k_unsorted_reference
from takzero_torch.ops import simhash as port_simhash
from takzero_torch.ops import topk as port_topk

torch.set_num_threads(2)

NEG = -3.0e38  # the search's mask value (search/core.py)


def _rows(mode: str, rows: int, a: int, rng) -> np.ndarray:
    if mode == "normal":
        return rng.standard_normal((rows, a)).astype(np.float32)
    if mode == "ties":
        return rng.integers(0, 4, (rows, a)).astype(np.float32)
    if mode in ("masked", "neginf"):
        fill = NEG if mode == "masked" else -np.inf
        x = np.full((rows, a), fill, np.float32)
        for i in range(rows):
            # Some rows hold fewer legal entries than k.
            j = rng.choice(a, int(rng.integers(10, 120)), replace=False)
            x[i, j] = rng.standard_normal(len(j)).astype(np.float32)
        return x
    if mode == "equal":
        # The dummy evaluator's rows: all ones, and ones under a legal mask.
        x = np.ones((rows, a), np.float32)
        x[rows // 2:] = np.where(rng.random((rows - rows // 2, a)) < 0.3, 1.0, NEG)
        return x
    raise ValueError(mode)


@pytest.mark.parametrize("mode", ["normal", "ties", "masked", "neginf", "equal"])
def test_topk_plain_matches_pallas_and_reference(mode):
    rng = np.random.default_rng(["normal", "ties", "masked", "neginf", "equal"].index(mode))
    x = _rows(mode, 4, 1030, rng)
    k = 64
    vals, idx = port_topk.topk_plain(torch.from_numpy(x), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    pv, pi = pallas_topk(jnp.asarray(x), k, interpret=True)
    rv, ri = exact_top_k_unsorted_reference(jnp.asarray(x), k)
    for want_v, want_i, what in ((pv, pi, "pallas"), (rv, ri, "reference")):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i), err_msg=what)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v), err_msg=what)


def test_topk_plain_matches_reference_at_main_path_width():
    """A = 9036 (6x6) and k = C = 256, rows from the search's masked logits."""
    rng = np.random.default_rng(9)
    x = np.concatenate([_rows(m, 3, 9036, rng) for m in ("normal", "masked", "equal")])
    vals, idx = port_topk.topk_plain(torch.from_numpy(x), 256)
    rv, ri = exact_top_k_unsorted_reference(jnp.asarray(x), 256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_topk_signed_zeros_tie_as_in_the_reference():
    """-0.0 and +0.0 tie and resolve by index in the reference's stable sort
    (and in the port's kernel, which keys -0.0 as +0.0).  The TPU kernel
    keys raw bits and ranks -0.0 below +0.0, so it is left out here."""
    x = np.array([[0.0, -0.0, 0.0, -0.0, -1.0, -0.0, 0.0, -2.0]], np.float32)
    vals, idx = port_topk.topk_plain(torch.from_numpy(x), 3)
    rv, ri = exact_top_k_unsorted_reference(jnp.asarray(x), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert idx.tolist() == [[0, 1, 2]]
    np.testing.assert_array_equal(np.signbit(vals.numpy()), np.signbit(np.asarray(rv)))


def test_topk_wrapper_dispatch_on_cpu():
    x = torch.randn(3, 50)
    before = port_topk.exact_top_k_unsorted.launches
    vals, idx = port_topk.exact_top_k_unsorted(x, 7)
    pv, pi = port_topk.topk_plain(x, 7)
    assert torch.equal(vals, pv) and torch.equal(idx, pi)
    assert port_topk.exact_top_k_unsorted.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="unsupported device"):
        port_topk.exact_top_k_unsorted(torch.empty(3, 50, device="meta"), 7)


def _simhash_case(b: int, inp: int, bits: int, planes: bool, seed: int):
    rng = np.random.default_rng(seed)
    if planes:  # plane-like inputs: mostly 0/1 with a few fractions
        x = (rng.random((b, inp)) < 0.2).astype(np.float32)
        tail = inp // 10
        x[:, -tail:] = rng.random((b, tail)).astype(np.float32)
    else:
        x = rng.standard_normal((b, inp)).astype(np.float32)
    m = rng.standard_normal((inp, bits)).astype(np.float32)
    return x, m


@pytest.mark.parametrize(
    "b,inp,bits,planes",
    [(8, 96, 32, False), (128, 1296, 26, True), (128, 1296, 32, True), (64, 243, 12, False)],
)
def test_simhash_plain_matches_pallas(b, inp, bits, planes):
    x, m = _simhash_case(b, inp, bits, planes, seed=b + bits)
    got = port_simhash.simhash_plain(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**bits
    dots = x.astype(np.float64) @ m.astype(np.float64)
    sure = (np.abs(dots) > 1e-4) @ (np.int64(1) << np.arange(bits, dtype=np.int64))
    for want in (
        simhash_pack(jnp.asarray(x), jnp.asarray(m), interpret=True),
        simhash_pack_reference(jnp.asarray(x), jnp.asarray(m)),
    ):
        want = np.asarray(want).astype(np.int64)
        np.testing.assert_array_equal(got & sure, want & sure)
    # And both follow the float64 sign where it is unambiguous.
    exact = (dots >= 0) @ (np.int64(1) << np.arange(bits, dtype=np.int64))
    np.testing.assert_array_equal(got & sure, exact & sure)


def test_simhash_wrapper_dispatch_on_cpu():
    x, m = torch.randn(5, 40), torch.randn(40, 20)
    before = port_simhash.simhash_pack.launches
    assert torch.equal(port_simhash.simhash_pack(x, m), port_simhash.simhash_plain(x, m))
    assert port_simhash.simhash_pack.launches == before
    with pytest.raises(ValueError):
        port_simhash.simhash_pack(x.to("meta"), m.to("meta"))
