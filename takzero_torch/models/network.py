"""The Tak ResNet as torch modules, and its BN-folded inference path.

Counterpart of ``takzero_tpu/models/network.py``: a conv3x3+BN+relu stem,
``blocks`` residual blocks of ``filters`` channels, a conv3x3 policy head
flattened channel-major (the action-index layout, and NCHW's natural
flatten), and value/UBE heads conv1x1 -> relu -> flatten -> dense(1)
(tanh on the value); the UBE head reads the detached core.

The modules follow flax's numerics, not torch's defaults, in both modes
(``net.train()`` / ``net.eval()``):

* a convolution (:func:`flax_conv`) is flax's ``nn.Conv(dtype=compute_dtype)``:
  its operands and bias are rounded to ``compute_dtype``, the product is
  taken in float32 (exact for bf16 operands) and rounded to
  ``compute_dtype``, and the bias is added in ``compute_dtype``;
* BatchNorm (:func:`flax_batch_norm`) computes in float32 over (B, H, W)
  with eps 1e-5.  In train mode it normalises with flax's fast batch
  variance ``max(0, mean(x^2) - mean(x)^2)`` and updates the running
  statistics to ``0.9 * old + 0.1 * batch`` with that same (biased)
  variance; in eval mode it uses the running statistics;
* the residual sums, the heads' flatten and their dense layers are float32.

The folded inference path follows ``apply_folded``: each convolution
takes its operands rounded to ``compute_dtype``, multiplies and accumulates
them in float32 (JAX's ``preferred_element_type=float32``), adds the f32
bias (and the residual) to that float32 result, and the activation is cast
back to ``compute_dtype`` where JAX casts: one rounding per layer, as in
the JAX package.  Unlike the modules, it does not round a convolution's
result.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.repr import input_channels, input_size
from ..tak.moves import action_space

MAXIMUM_VARIANCE = 4.0  # value span is [-1, 1] -> variance <= 2^2
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9


@dataclasses.dataclass(frozen=True)
class NetConfig:
    n: int = 6
    half_komi: int = 4
    filters: int = 256
    blocks: int = 16
    novelty: str = "simhash"  # simhash | none in this slice
    hash_bits: int = 32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def num_actions(self) -> int:
        return action_space(self.n).num_actions

    @property
    def output_channels(self) -> int:
        return action_space(self.n).num_channels


def flax_conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)`` with ``conv``'s weights ("SAME" padding).

    Every operand of the float32 convolution is ``dtype``-exact, in the
    backward pass too (autograd rounds each gradient to ``dtype`` where the
    forward rounds), so cuDNN's TF32 is exact for bf16 under
    :func:`conv_precision`.
    """
    pad = conv.kernel_size[0] // 2
    y = F.conv2d(x.to(dtype).float(), conv.weight.to(dtype).float(), padding=pad).to(dtype)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[None, :, None, None]
    return y


def flax_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``.

    In train mode the running statistics of ``bn`` are updated in place
    (outside autograd), as flax's mutable ``batch_stats``.
    """
    x = x.float()
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean + (1 - _BN_MOMENTUM) * mean)
            bn.running_var.copy_(_BN_MOMENTUM * bn.running_var + (1 - _BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + _BN_EPS) * bn.weight
    y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
    return y + bn.bias[None, :, None, None]


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)  # parameter holder; see flax_batch_norm

    def forward(self, x):
        return flax_batch_norm(self.bn, flax_conv(self.conv, x, self.dtype), self.training)


class ResBlock(nn.Module):
    def __init__(self, filters: int, dtype: torch.dtype):
        super().__init__()
        self.a = ConvBN(filters, filters, dtype)
        self.b = ConvBN(filters, filters, dtype)

    def forward(self, x):
        return F.relu(x + self.b(F.relu(self.a(x))))


class Core(nn.Module):
    def __init__(self, cfg: NetConfig):
        super().__init__()
        dt = cfg.compute_dtype
        self.stem = ConvBN(input_channels(cfg.n), cfg.filters, dt)
        self.blocks = nn.ModuleList(ResBlock(cfg.filters, dt) for _ in range(cfg.blocks))

    def forward(self, x):
        x = F.relu(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        return x


class ScalarHead(nn.Module):
    """conv1x1 -> relu -> flatten -> dense(1) in float32; optional tanh."""

    def __init__(self, cfg: NetConfig, tanh: bool):
        super().__init__()
        self.tanh = tanh
        self.dtype = cfg.compute_dtype
        self.conv = nn.Conv2d(cfg.filters, 1, 1)
        self.dense = nn.Linear(cfg.n * cfg.n, 1)

    def forward(self, x):
        h = F.relu(flax_conv(self.conv, x, self.dtype)).flatten(1).float()
        out = self.dense(h)[:, 0]
        return torch.tanh(out) if self.tanh else out


class TakNet(nn.Module):
    """planes [B, C, N, N] -> (policy [B, A], value [B], ube [B]), float32.

    Built in eval mode; ``net.train()`` switches BatchNorm to batch
    statistics (and running-statistics updates) for the learner.
    """

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        self.core = Core(cfg)
        self.policy = nn.Conv2d(cfg.filters, cfg.output_channels, 3, padding=1)
        self.value = ScalarHead(cfg, tanh=True)
        self.ube = ScalarHead(cfg, tanh=False)
        self.eval()

    def forward(self, planes):
        core = self.core(planes)
        policy = flax_conv(self.policy, core, self.cfg.compute_dtype).flatten(1).float()
        return policy, self.value(core), self.ube(core.detach())


def init_network(cfg: NetConfig, seed: int = 0) -> TakNet:
    """Random weights from a torch generator (He-normal convs, LeCun-normal
    dense kernels, zero biases, identity BatchNorm), built on the CPU so the
    draw does not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    net = TakNet(cfg)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, (1.0 / mod.in_features) ** 0.5, generator=gen)
                mod.bias.zero_()
    return net.eval()


def simhash_matrix(cfg: NetConfig, seed: int = 0) -> torch.Tensor:
    """Fixed Gaussian projection [input_size, hash_bits] from a torch
    generator.  It is NOT the JAX package's matrix for the same seed (torch
    cannot redraw JAX's PRNG); a JAX bundle's matrix comes in through
    ``takzero_torch.bridge``."""
    gen = torch.Generator().manual_seed(seed ^ 0x51A5)
    return torch.randn((input_size(cfg.n), cfg.hash_bits), generator=gen)


# ---------------------------------------------------------------------------
# BN-folded inference path
# ---------------------------------------------------------------------------


def _fold(convbn: ConvBN, dtype):
    bn = convbn.bn
    s = bn.weight / torch.sqrt(bn.running_var + _BN_EPS)
    w = (convbn.conv.weight * s[:, None, None, None]).to(dtype)
    return w, bn.bias - bn.running_mean * s


@torch.no_grad()
def fold_inference_params(cfg: NetConfig, net: TakNet) -> dict:
    """Fold the core's ConvBN pairs into (kernel in compute_dtype, f32 bias);
    heads are copied (they have biases)."""
    dt = cfg.compute_dtype
    head = lambda h: (h.conv.weight, h.conv.bias, h.dense.weight, h.dense.bias)  # noqa: E731
    return {
        "stem": _fold(net.core.stem, dt),
        "blocks": [(_fold(b.a, dt), _fold(b.b, dt)) for b in net.core.blocks],
        "policy": (net.policy.weight, net.policy.bias),
        "value": head(net.value),
        "ube": head(net.ube),
    }


def _conv2d(x, kernel, bias, dtype):
    """Convolution of the operands rounded to ``dtype``, multiplied and
    accumulated in float32, plus the f32 bias in float32."""
    pad = kernel.shape[-1] // 2
    y = F.conv2d(x.to(dtype).float(), kernel.to(dtype).float(), padding=pad)
    return y + bias.float()[None, :, None, None]


@contextlib.contextmanager
def conv_precision(dtype):
    """cuDNN flags for the convolutions of ``_conv2d`` in ``dtype``.

    For a 16-bit ``dtype``, cuDNN may use TF32 tensor cores inside this
    context only (the other flags stay as they are): every bf16 or fp16
    value is exactly a TF32 value, so each product is exact and the sums
    stay in float32.  That holds for a direct or implicit-GEMM algorithm; a
    Winograd or FFT algorithm transforms the operands first and would not
    keep it (``chip_smoke.py`` holds a card convolution against float64 and
    the card's bf16 network against the CPU's).  A float32 ``dtype`` keeps
    the global flag.
    """
    cudnn = torch.backends.cudnn
    exact_tf32 = dtype in (torch.bfloat16, torch.float16)
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic,
                     allow_tf32=exact_tf32 or cudnn.allow_tf32):
        yield


@torch.no_grad()
def apply_folded(cfg: NetConfig, fw: dict, planes: torch.Tensor):
    """Inference on folded weights: (policy f32[B,A], value f32[B], ube f32[B])."""
    dt = cfg.compute_dtype
    with conv_precision(dt):
        x = F.relu(_conv2d(planes, *fw["stem"], dt)).to(dt)
        for (k1, b1), (k2, b2) in fw["blocks"]:
            y = F.relu(_conv2d(x, k1, b1, dt)).to(dt)
            y = _conv2d(y, k2, b2, dt)
            x = F.relu(x.float() + y).to(dt)
        core = x
        policy = _conv2d(core, *fw["policy"], dt).flatten(1)

        def scalar_head(w, tanh):
            ck, cb, dk, db = w
            h = F.relu(_conv2d(core, ck, cb, dt)).flatten(1)
            out = (h @ dk.float().t() + db.float())[:, 0]
            return torch.tanh(out) if tanh else out

        return policy, scalar_head(fw["value"], True), scalar_head(fw["ube"], False)
