"""Exact unsorted top-k: kernel A of the port.

Replaces ``takzero_tpu/ops/topk.py:_topk_kernel`` (the Pallas radix-select
reached through ``exact_top_k_unsorted``), which the search calls in every
expansion.  Semantics (the contract of ``exact_top_k_unsorted_reference``):
the k largest values per row, ties toward the lower index, output ordered
by ascending index, values returned exactly (±inf included).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``takzero_torch/csrc/topk.cu`` (one block per row, the row held in shared
memory, a 4-pass 8-bit radix select of the threshold, block scans that rank
the ties and place the outputs); on a CPU tensor it runs :func:`topk_plain`.
The kernel is memory-bound: at the main path's f32[128, 9036], k=256 it
must move 4.9 MB, about 1.5 us at the H100's 3.35 TB/s.

The row must fit in shared memory: 6x6 (A=9036, 36 KB) and 7x7 (A=24843,
97 KB, through the dynamic shared-memory attribute) do; 8x8 (A=65216,
255 KB) does not, and the wrapper raises.
"""

from __future__ import annotations

import torch

from . import _build

# Largest dynamic shared memory a block may use on Hopper (232,448 B),
# less the kernel's static histogram and scan scratch.
_SMEM_LIMIT = 232_448 - 2_048


def topk_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version: (vals f32[B,k], idx i32[B,k]).

    A stable sort on -x ranks by value with ties in index order; the first
    k indices are re-sorted ascending and gathered.
    """
    order = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    top = torch.sort(order, dim=-1).values
    return x.gather(-1, top), top.to(torch.int32)


def exact_top_k_unsorted(x: torch.Tensor, k: int):
    """(vals f32[B,k], idx i32[B,k]): the k largest per row, unsorted.

    CPU tensor -> :func:`topk_plain`; CUDA tensor -> the CUDA kernel (or an
    exception).  ``exact_top_k_unsorted.launches`` counts kernel launches.
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
    if 4 * a > _SMEM_LIMIT:
        raise ValueError(
            f"exact_top_k_unsorted: a row of A={a} floats does not fit in "
            f"shared memory ({4 * a} > {_SMEM_LIMIT} bytes)"
        )
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b:
        with torch.cuda.device(x.device):
            err = _build.lib("topk").topk_launch(
                x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, a, k,
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(err, "topk")
        exact_top_k_unsorted.launches += 1
    return vals, idx


exact_top_k_unsorted.launches = 0
