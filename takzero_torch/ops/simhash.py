"""Fused SimHash pack: kernel B of the port.

Replaces ``takzero_tpu/ops/pallas_kernels.py:_simhash_kernel`` (the Pallas
kernel reached through ``simhash_pack``), which every network evaluation
calls for the novelty lookup.  Semantics (``simhash_pack_reference``):
bit i of the word is set iff ``(x @ M)[:, i] >= 0``, with the dot product
in full float32.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``takzero_torch/csrc/simhash.cu``; on a CPU tensor it runs
:func:`simhash_plain`.  The kernel splits the input dimension over a
cluster of 8 blocks that share a tile of 8 rows (128 blocks at the main
path's shape), stages x and M in shared memory with ``cp.async``, computes
the partial dots with float32 FMAs, sums them through distributed shared
memory in the fixed order of cluster rank (the same input gives the same
word on every run) and packs each word with one ballot.  At the main
path's x f32[128, 1296] and M f32[1296, 26] it must move about 0.8 MB for
8.6 MFLOP, so it is memory-bound: about 0.24 us at the H100's 3.35 TB/s.
A block's slice of M and x must fit in shared memory, which takes In up to
about 11,000 (8x8 needs 2,816).

Words are returned as int64 holding the uint32 value (torch has no uint32
shifts); the kernel writes them so.
"""

from __future__ import annotations

import torch

from . import _build


def simhash_plain(x: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int64[B] = pack(x @ M >= 0) in float32."""
    dots = x.to(torch.float32) @ matrix.to(torch.float32)
    bits = (dots >= 0).to(torch.int64)
    powers = torch.ones(
        matrix.shape[1], dtype=torch.int64, device=x.device
    ) << torch.arange(matrix.shape[1], device=x.device)
    return (bits * powers).sum(dim=-1)


def simhash_pack(x: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """int64[B] packed sign bits of ``x @ matrix`` (bits <= 32).

    CPU tensors -> :func:`simhash_plain`; CUDA tensors -> the CUDA kernel
    (or an exception).  Its launches count under ``simhash_pack``
    (``_build.launch_counts``).
    """
    if x.device.type == "cpu" and matrix.device.type == "cpu":
        return simhash_plain(x, matrix)
    if x.device.type != "cuda" or matrix.device != x.device:
        raise ValueError(
            f"simhash_pack: x on {x.device} and matrix on {matrix.device}"
        )
    if x.dtype != torch.float32 or matrix.dtype != torch.float32:
        raise ValueError(f"simhash_pack: need f32, got {x.dtype}, {matrix.dtype}")
    if x.dim() != 2 or matrix.dim() != 2 or x.shape[1] != matrix.shape[0]:
        raise ValueError(
            f"simhash_pack: shapes {tuple(x.shape)} @ {tuple(matrix.shape)}"
        )
    if not (x.is_contiguous() and matrix.is_contiguous()):
        raise ValueError("simhash_pack: inputs must be contiguous")
    b, inp = x.shape
    bits = matrix.shape[1]
    if not 0 < bits <= 32:
        raise ValueError(f"simhash_pack: bits must be in [1, 32], got {bits}")
    out = torch.empty((b,), dtype=torch.int64, device=x.device)
    if b:
        with torch.cuda.device(x.device):
            _build.launch("simhash", "simhash_launch", x.data_ptr(), matrix.data_ptr(), out.data_ptr(), b, inp,
                          bits, torch.cuda.current_stream().cuda_stream)
    return out
