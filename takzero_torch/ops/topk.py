"""Exact unsorted top-k: kernel A of the port.

Replaces ``takzero_tpu/ops/topk.py:_topk_kernel`` (the Pallas radix-select
reached through ``exact_top_k_unsorted``), which the search calls in every
expansion.  Semantics (the contract of ``exact_top_k_unsorted_reference``):
the k largest values per row, ties toward the lower index, output ordered
by ascending index, values returned exactly (±inf included).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``takzero_torch/csrc/topk.cu``; on a CPU tensor it runs :func:`topk_plain`.
The kernel gives each row a 1024-thread block: it reads the row once into
shared memory, builds an 11-bit histogram of the keys' top digit in one
sweep, compacts the threshold bin's keys and stops there when they are all
equal (the main path's masked rows, whose threshold is the mask value),
else resolves the two remaining digits over those candidates alone, and
places the outputs in index order with one block-wide scan.  It is
memory-bound: at the main path's f32[128, 9036], k=256 it must move 4.9 MB,
about 1.5 us at the H100's 3.35 TB/s.

The search's other choices of top-k (``search/core.py`` ``make_topk``,
``TAKZERO_TOPK``) are library calls, as their JAX counterparts are XLA's
``lax.top_k`` outside any Pallas kernel: :func:`lax_top_k` (sorted, with
``lax.top_k``'s order) and :func:`exact_top_k_unsorted_grouped` (JAX's
two-stage grouped top-k).  :func:`exact_top_k_unsorted_reference` is
:func:`topk_plain` under the name of JAX's contract function.

Rows whose row and candidates fit in shared memory (8 bytes an entry:
6x6, A=9036, 72 KB; 7x7, A=24843, 194 KB) take that kernel.  Wider rows
(8x8, A=65216, 510 KB) take a second kernel in the same source that
leaves the row in device memory and copies the candidates to a workspace
the wrapper allocates (u32[B, A]); the wrapper picks by width.  Bound at
f32[128, 65216], k=256: 33.7 MB, about 10.0 us at 3.35 TB/s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# Largest shared memory a block may use on Hopper (232,448 B), less the
# kernel's static histogram and scan scratch: rows up to _SMEM_LIMIT / 8
# entries take the shared-memory kernel.
_SMEM_LIMIT = 232_448 - 9_216


def topk_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version: (vals f32[B,k], idx i32[B,k]).

    A stable sort on -x ranks by value with ties in index order; the first
    k indices are re-sorted ascending and gathered.
    """
    order = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    top = torch.sort(order, dim=-1).values
    return x.gather(-1, top), top.to(torch.int32)


# Under JAX's contract name (``takzero_tpu/ops/topk.py:231``).
exact_top_k_unsorted_reference = topk_plain


def lax_top_k(x: torch.Tensor, k: int):
    """(vals f32[..., k], idx i32[..., k]): the k largest along the last
    axis, sorted descending, with ``jax.lax.top_k``'s order: floats in
    their total order (+0.0 above -0.0) and ties to the lower index.

    ``torch.topk`` documents no order among equal values, so it runs on
    int64 keys that cannot tie: the float's bits made monotone in the high
    half, the reversed index in the low half.
    """
    bits = x.contiguous().view(torch.int32)
    high = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    idx = torch.topk(high * 2**32 + (2**31 - 1 - pos), k, dim=-1, sorted=True).indices
    return x.gather(-1, idx), idx.to(torch.int32)


def exact_top_k_unsorted_grouped(x: torch.Tensor, k: int, groups: int = 8):
    """JAX's two-stage grouped top-k (``takzero_tpu/ops/topk.py:202``),
    step for step: each row split into ``groups`` chunks (clamped to
    ``A // k``, the last padded with -inf), the top k of each chunk, then
    the top k of the ``groups * k`` survivors.  Exact, since every global
    top-k entry is in its chunk's top k; sorted descending, int32 indices.
    """
    b, a = x.shape
    if a < k:
        raise ValueError(f"exact_top_k_unsorted_grouped: need k <= A, got k={k}, A={a}")
    groups = max(1, min(groups, a // k))
    if groups == 1:
        return lax_top_k(x, k)
    xp = F.pad(x, (0, (-a) % groups), value=-torch.inf)
    sub = xp.reshape(b, groups, -1)
    v1, i1 = lax_top_k(sub, k)  # [B, G, k]
    base = torch.arange(groups, dtype=torch.int32, device=x.device)[None, :, None] * sub.shape[-1]
    v2, i2 = lax_top_k(v1.reshape(b, groups * k), k)
    idx = (i1 + base).reshape(b, groups * k).gather(-1, i2.to(torch.int64))
    return v2, idx


def exact_top_k_unsorted(x: torch.Tensor, k: int):
    """(vals f32[B,k], idx i32[B,k]): the k largest per row, unsorted.

    CPU tensor -> :func:`topk_plain`; CUDA tensor -> the CUDA kernel (or an
    exception).  Its launches count under ``exact_top_k_unsorted``
    (``_build.launch_counts``).
    """
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"exact_top_k_unsorted: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"exact_top_k_unsorted: need contiguous f32[B, A], got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    b, a = x.shape
    if not 0 < k <= a:
        raise ValueError(f"exact_top_k_unsorted: need 0 < k <= A, got k={k}, A={a}")
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            if 8 * a <= _SMEM_LIMIT:
                _build.launch("topk", "topk_launch", x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, a, k, stream)
            else:
                work = torch.empty((b, a), dtype=torch.int32, device=x.device)
                _build.launch("topk", "topk_wide_launch", x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                              work.data_ptr(), b, a, k, stream)
    return vals, idx
