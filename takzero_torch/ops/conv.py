"""The evaluator's 3x3 convolutions as one Hopper kernel a layer.

Replaces no TPU kernel: the JAX package leaves its convolutions to XLA
(``takzero_tpu/models/network.py`` ``apply_folded``).  The port ran them as
cuDNN TF32 convolutions of float32 copies of the bf16 operands, with layout
transposes and separate bias, residual and relu passes (``models/network.py``
``_conv2d``, which the CPU and the float32 path still take).  On a CUDA
tensor in bf16, ``models/network.py`` ``apply_folded`` instead runs the stem,
every tower layer and the policy head through :func:`conv3x3`, which launches
``takzero_torch/csrc/conv.cu`` (its header has the design): an implicit GEMM
on ``wgmma`` with bf16 operands and float32 accumulators, whose epilogue adds
the float32 bias and residual, applies relu and rounds to bf16 once, exactly
the folded path's function up to the order of the float32 sums.

Layouts:

* between layers the activations are NHWC bf16 ``[B, n, n, C_pad]``, with
  ``C_pad`` the filters rounded up to 64 (the kernel's K-block); the padded
  channels have zero weights and bias, so they stay 0 through the tower;
* the stem reads the float32 NCHW planes of ``ops/repr.py`` as they are and
  rounds them to bf16 while it stages them;
* the head launch computes the policy's channels and, as two more output
  channels, the value and UBE heads' 1x1 convolutions (at the centre tap);
  it writes the policy f32 ``[B, C n n]`` channel-major (``apply_folded``'s
  flatten) and the two heads' relued maps f32 ``[B, 2, n n]``;
* a layer's weights are packed once, when the network is folded
  (:func:`pack_folded`), as bf16 ``[9 C_in_pad / 64, C_out_pad, 64]``:
  K-block-major in (64-channel block, tap) order, each row the 64 channels
  of one tap for one output channel, its 16-byte chunks already in the
  128-byte swizzle that ``wgmma`` reads.

:func:`conv3x3_plain` is the same function in plain torch, from the packed
weights; the CPU tests hold it to ``_conv2d`` and ``chip_smoke.py`` holds the
kernel to it.  Its launches count under ``conv3x3``
(``_build.launch_counts``): ``2 blocks + 2`` an evaluation (34 at
net6_simhash, 42 at net5).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import _build

BK = 64  # the kernel's K-block: 64 bf16 channels, one 128-byte row
SMS = 132  # streaming multiprocessors of an H100 SXM
MODES = {"tower": 0, "stem": 1, "head": 2}


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One packed convolution: ``weight`` (:func:`pack_weight`), ``bias``
    f32 ``[C_out_pad]`` (0 past ``cout``), the real input and output
    channels, and for the head the number of policy channels (``split``)."""

    weight: torch.Tensor
    bias: torch.Tensor
    cin: int
    cout: int
    split: int | None = None

    @property
    def cblocks(self) -> int:
        return self.weight.shape[0] // 9

    @property
    def cout_pad(self) -> int:
        return self.weight.shape[1]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _swizzle(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` [..., R, 64] with each row's 16-byte chunk c moved to
    ``c ^ (row % 8)``, the 128-byte swizzle; its own inverse."""
    r = rows.shape[-2]
    src = torch.arange(8, device=rows.device)[None, :] ^ (torch.arange(r, device=rows.device) % 8)[:, None]
    chunks = rows.reshape(*rows.shape[:-1], 8, 8)
    return torch.gather(chunks, -2, src[..., None].expand(chunks.shape)).reshape(rows.shape)


def pack_weight(kernel: torch.Tensor) -> torch.Tensor:
    """A [C_out, C_in, k, k] kernel (k = 3, or 1 at the centre tap), rounded
    to bf16, as the kernel's bf16 [9 C_in_pad / 64, C_out_pad, 64] (K in
    (channel block, tap, channel) order, each row swizzled), zero-padded to
    multiples of 64."""
    cout, cin, kh, kw = kernel.shape
    cin_pad, cout_pad = _round_up(cin, BK), _round_up(cout, BK)
    full = torch.zeros((cout_pad, cin_pad, 3, 3), dtype=torch.bfloat16, device=kernel.device)
    o = (3 - kh) // 2
    full[:cout, :cin, o:o + kh, o:o + kw] = kernel.to(torch.bfloat16)
    rows = full.reshape(cout_pad, cin_pad // BK, BK, 3, 3).permute(0, 1, 3, 4, 2)
    return _swizzle(rows.reshape(cout_pad, 9 * cin_pad // BK, BK).transpose(0, 1)).contiguous()


def unpack_weight(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_weight`: bf16 [C_out_pad, C_in_pad, 3, 3]."""
    kb, cout_pad, _ = packed.shape
    rows = _swizzle(packed).transpose(0, 1).reshape(cout_pad, kb // 9, 3, 3, BK)
    return rows.permute(0, 1, 4, 2, 3).reshape(cout_pad, kb // 9 * BK, 3, 3)


def _layer(kernel: torch.Tensor, bias: torch.Tensor, split: int | None = None) -> ConvLayer:
    weight = pack_weight(kernel)
    padded = torch.zeros(weight.shape[1], dtype=torch.float32, device=kernel.device)
    padded[: bias.shape[0]] = bias.float()
    return ConvLayer(weight, padded, cin=kernel.shape[1], cout=kernel.shape[0], split=split)


@torch.no_grad()
def pack_folded(fw: dict) -> dict:
    """The convolutions of ``fold_inference_params``' weights as packed
    layers: ``stem``, ``blocks`` (pairs), and ``head``: the policy kernel
    with the value and UBE 1x1 kernels as two more output channels."""
    (pk, pb), (vk, vb), (uk, ub) = fw["policy"], fw["value"][:2], fw["ube"][:2]
    center = lambda k: F.pad(k, (1, 1, 1, 1))  # noqa: E731
    head = _layer(torch.cat([pk.float(), center(vk.float()), center(uk.float())]), torch.cat([pb, vb, ub]),
                  split=pk.shape[0])
    return {
        "stem": _layer(*fw["stem"]),
        "blocks": [(_layer(*a), _layer(*b)) for a, b in fw["blocks"]],
        "head": head,
    }


def choose_tile(m: int, cout_pad: int) -> tuple[int, int]:
    """(BM, BN) of the launch: 128 x 128 tiles (two warpgroups) while they
    still give half the SMs a tile, else 64-row tiles (two fit an SM), 64
    columns wide where the channels are not a multiple of 128: the faster
    choice at both selfplay cells' shapes (``PERF.md`` §6)."""
    bn = 128 if cout_pad % 128 == 0 else 64
    bm = 128 if bn == 128 and _round_up(m, 128) // 128 * (cout_pad // bn) >= SMS // 2 else 64
    return bm, bn


def _mode(x: torch.Tensor, layer: ConvLayer) -> str:
    if layer.split is not None:
        return "head"
    return "stem" if x.dtype == torch.float32 else "tower"


def _check(x: torch.Tensor, layer: ConvLayer, residual, mode: str) -> tuple[int, int, int]:
    """(B, n, the kernel's cin) of a valid call; raises on anything else."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"conv3x3: x must be a contiguous 4-d tensor, got {tuple(x.shape)}")
    if mode == "stem":
        b, cin, n, n2 = x.shape
        if cin != layer.cin:
            raise ValueError(f"conv3x3: the stem takes {layer.cin} planes, got {cin}")
    else:
        b, n, n2, cin = x.shape
        if x.dtype != torch.bfloat16 or cin != layer.cblocks * BK:
            raise ValueError(f"conv3x3: x must be bf16 NHWC with {layer.cblocks * BK} channels, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if n != n2:
        raise ValueError(f"conv3x3: square boards only, got {tuple(x.shape)}")
    if residual is not None and (mode == "head" or residual.shape != (b, n, n, layer.cout_pad)
                                 or residual.dtype != torch.bfloat16 or not residual.is_contiguous()):
        raise ValueError(f"conv3x3: a residual must be contiguous bf16 [{b}, {n}, {n}, {layer.cout_pad}]")
    return b, n, cin


def conv3x3_plain(x: torch.Tensor, layer: ConvLayer, residual: torch.Tensor | None = None):
    """:func:`conv3x3` in plain torch, from the packed weights: the products
    of bf16 values summed in float32 by ``F.conv2d``, the f32 bias (and the
    residual) added, relu, one rounding to bf16; the head's policy channels
    f32 and unrelued.  On a CUDA tensor ``F.conv2d`` follows cuDNN's TF32
    flag, which is exact for these operands."""
    mode = _mode(x, layer)
    _check(x, layer, residual, mode)
    w = unpack_weight(layer.weight).float()
    if mode == "stem":
        xin = F.pad(x.to(torch.bfloat16).float(), (0, 0, 0, 0, 0, w.shape[1] - x.shape[1]))
    else:
        xin = x.permute(0, 3, 1, 2).float()
    acc = F.conv2d(xin, w, padding=1) + layer.bias[None, :, None, None]
    if mode == "head":
        return acc[:, : layer.split].flatten(1), F.relu(acc[:, layer.split : layer.cout]).flatten(2)
    if residual is not None:
        acc = acc + residual.permute(0, 3, 1, 2).float()
    return F.relu(acc).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def conv3x3(x: torch.Tensor, layer: ConvLayer, residual: torch.Tensor | None = None):
    """One layer: ``relu(conv(x) + bias [+ residual])`` as bf16 NHWC
    ``[B, n, n, C_out_pad]``, or for the head layer (policy f32 [B, split n n],
    heads f32 [B, cout - split, n n]).

    ``x`` is the stem's float32 NCHW planes or the bf16 NHWC activations.
    CPU tensors -> :func:`conv3x3_plain`; CUDA tensors -> the kernel, on
    the tile of :func:`choose_tile`, or an exception.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, layer, residual)
    mode = _mode(x, layer)
    b, n, cin = _check(x, layer, residual, mode)
    dev = x.device
    if x.device.type != "cuda" or any(t.device != dev for t in (layer.weight, layer.bias)):
        raise ValueError(f"conv3x3: x on {x.device}, weights on {layer.weight.device}")
    if residual is not None and residual.device != dev:
        raise ValueError(f"conv3x3: the residual is on {residual.device}, x on {dev}")
    m, nn = b * n * n, n * n
    if mode == "head":
        out0 = torch.empty((b, layer.split * nn), dtype=torch.float32, device=dev)
        out1 = torch.empty((b, layer.cout - layer.split, nn), dtype=torch.float32, device=dev)
        result = (out0, out1)
    else:
        out0 = torch.empty((b, n, n, layer.cout_pad), dtype=torch.bfloat16, device=dev)
        out1 = None
        result = out0
    if m:
        bm, bn = choose_tile(m, layer.cout_pad)
        with torch.cuda.device(dev):
            _build.launch(
                "conv", "conv3x3_launch",
                x.data_ptr(), layer.weight.data_ptr(), layer.bias.data_ptr(),
                None if residual is None else residual.data_ptr(), out0.data_ptr(),
                None if out1 is None else out1.data_ptr(), m, n, cin, layer.cblocks, layer.cout_pad,
                layer.cout, layer.split or 0, MODES[mode], bm, bn, torch.cuda.current_stream().cuda_stream,
            )
    return result
