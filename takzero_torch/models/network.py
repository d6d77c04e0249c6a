"""The Tak ResNet as torch modules, and its BN-folded inference path.

Counterpart of ``takzero_tpu/models/network.py``: a conv3x3+BN+relu stem,
``blocks`` residual blocks of ``filters`` channels, a conv3x3 policy head
flattened channel-major (the action-index layout, and NCHW's natural
flatten), and value/UBE heads conv1x1 -> relu -> flatten -> dense(1)
(tanh on the value); the UBE head reads the detached core.  Beside it, the
novelty modules: the RND predictor/target pair (:class:`RndPair`, a conv
tower or net5's MLP) and the ensemble value heads (:class:`EnsembleHeads`).

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
  variance (under :func:`global_batch_stats`, over every rank's rows); in
  eval mode it uses the running statistics;
* the residual sums, the heads' flatten and their dense layers are float32;
* a dense layer of the RND MLP (:func:`flax_dense`) is flax's
  ``nn.Dense(dtype=compute_dtype)``, rounded as a convolution is;
* the RND tower's LayerNorm (:class:`FlaxLayerNorm`) is flax's
  ``nn.LayerNorm(reduction_axes=(1, 2, 3))``: float32, eps 1e-6, the fast
  variance, a scale and a bias per channel.

The folded inference path follows ``apply_folded``: each convolution
takes its operands rounded to ``compute_dtype``, multiplies and accumulates
them in float32 (JAX's ``preferred_element_type=float32``), adds the f32
bias (and the residual) to that float32 result, and the activation is cast
back to ``compute_dtype`` where JAX casts: one rounding per layer, as in
the JAX package.  Unlike the modules, it does not round a convolution's
result.  In bf16 on a CUDA card it runs each convolution as one launch of
``ops/conv.py``'s kernel, bias, residual and relu in its epilogue, with the
activations NHWC from the stem to the core (:func:`apply_packed`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv
from ..ops.repr import input_channels, input_size
from ..parallel import multihost
from ..tak.moves import action_space

MAXIMUM_VARIANCE = 4.0  # value span is [-1, 1] -> variance <= 2^2
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9
_LN_EPS = 1e-6
RND_MLP_WIDTHS = (1024, 1024, 512)
RND_OUT_FILTERS = 32  # the RND tower's last ConvBN


@dataclasses.dataclass(frozen=True)
class NetConfig:
    n: int = 6
    half_komi: int = 4
    filters: int = 256
    blocks: int = 16
    novelty: str = "simhash"  # simhash | lcghash | rnd | ensemble | none
    hash_bits: int = 32
    rnd_filters: int = 32
    rnd_blocks: int = 4
    rnd_mlp: bool = False  # net5-style MLP RND instead of the conv tower
    ensemble_size: int = 16
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


_GLOBAL_BATCH_STATS = False  # see global_batch_stats


@contextlib.contextmanager
def global_batch_stats(on: bool = True):
    """Inside, train-mode BatchNorm takes its statistics over the global
    batch of every rank of the process group, as JAX's data-parallel train
    step does under GSPMD: the per-rank sums of x and x^2 go through a
    differentiable all-reduce, so the backward pass carries each rank's
    terms to every other rank.  ``on=False`` is a no-op."""
    global _GLOBAL_BATCH_STATS
    before = _GLOBAL_BATCH_STATS
    _GLOBAL_BATCH_STATS = on
    try:
        yield
    finally:
        _GLOBAL_BATCH_STATS = before


def flax_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``.

    In train mode the running statistics of ``bn`` are updated in place
    (outside autograd), as flax's mutable ``batch_stats``; under
    :func:`global_batch_stats` the batch is every rank's (equal) rows.
    """
    x = x.float()
    if train:
        if _GLOBAL_BATCH_STATS:
            count = x.shape[0] * x.shape[2] * x.shape[3] * multihost.world_size()
            sums = multihost.all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]))
            mean, mean_sq = (sums / count).chunk(2)
        else:
            mean, mean_sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean + (1 - _BN_MOMENTUM) * mean)
            bn.running_var.copy_(_BN_MOMENTUM * bn.running_var + (1 - _BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + _BN_EPS) * bn.weight
    y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
    return y + bn.bias[None, :, None, None]


def flax_dense(dense: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with ``dense``'s weights: operands
    rounded to ``dtype``, the float32 product rounded to ``dtype``, the bias
    added in ``dtype``."""
    y = F.linear(x.to(dtype).float(), dense.weight.to(dtype).float()).to(dtype)
    return y + dense.bias.to(dtype)


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(reduction_axes=(1, 2, 3))`` on NCHW planes: float32
    statistics over (C, H, W) with the fast variance, eps 1e-6, and a
    scale and a bias per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp((x * x).mean(dim=(1, 2, 3), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + _LN_EPS) * self.weight[None, :, None, None]
        return (x - mean) * mul + self.bias[None, :, None, None]


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
    """conv1x1 -> relu -> flatten -> dense(1) in float32; optional tanh.

    Applied to an NCHW core: the conv's single channel flattens to the same
    order as JAX's NHWC."""

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
    ``with_core=True`` appends the residual tower's output
    (``compute_dtype`` [B, F, N, N]) in the same mode, so that extra heads
    (EEE's ensemble) read this forward's core instead of running a second
    tower (JAX's ``TakNet.__call__(with_core=True)``).
    """

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        self.core = Core(cfg)
        self.policy = nn.Conv2d(cfg.filters, cfg.output_channels, 3, padding=1)
        self.value = ScalarHead(cfg, tanh=True)
        self.ube = ScalarHead(cfg, tanh=False)
        self.eval()

    def forward(self, planes, with_core: bool = False):
        core = self.core(planes)
        policy = flax_conv(self.policy, core, self.cfg.compute_dtype).flatten(1).float()
        out = (policy, self.value(core), self.ube(core.detach()))
        return out + (core,) if with_core else out


class RndTower(nn.Module):
    """RND conv tower (net4_rnd.rs:126-166): LayerNorm over the float32
    planes, then in ``compute_dtype`` conv/BN/relu, ``rnd_blocks`` residual
    blocks of ``rnd_filters`` channels and a last ConvBN(32) without relu,
    flattened in NHWC order (JAX's) to float32."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        dt = self.dtype = cfg.compute_dtype
        c = input_channels(cfg.n)
        self.norm = FlaxLayerNorm(c)
        self.stem = ConvBN(c, cfg.rnd_filters, dt)
        self.blocks = nn.ModuleList(ResBlock(cfg.rnd_filters, dt) for _ in range(cfg.rnd_blocks))
        self.head = ConvBN(cfg.rnd_filters, RND_OUT_FILTERS, dt)

    def forward(self, planes):
        x = F.relu(self.stem(self.norm(planes).to(self.dtype)))
        for blk in self.blocks:
            x = blk(x)
        return self.head(x).permute(0, 2, 3, 1).flatten(1).float()


class RndMlp(nn.Module):
    """net5-style MLP RND (net5.rs:122-148): the channel-major planes
    flattened as they are, divided by their L2 norm + 1e-8, then three
    dense layers (1024, 1024, 512) in ``compute_dtype``, each followed by
    relu."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.dtype = cfg.compute_dtype
        dims = (input_size(cfg.n),) + RND_MLP_WIDTHS
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, planes):
        x = planes.flatten(1).float()
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
        for dense in self.layers:
            x = F.relu(flax_dense(dense, x, self.dtype))
        return x.float()


class RndPair(nn.Module):
    """Predictor + frozen target; ``forward(planes)`` is the per-example
    squared error f32[B].

    The target is always in eval mode (JAX applies it with ``train=False``,
    even in the train step): its BatchNorm keeps its initial running
    statistics, it gets no gradient and its weights never change.
    ``train()`` switches the predictor only.
    """

    def __init__(self, cfg: NetConfig):
        super().__init__()
        tower = RndMlp if cfg.rnd_mlp else RndTower
        self.predictor = tower(cfg)
        self.target = tower(cfg).requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        self.target.eval()
        return self

    def forward(self, planes):
        pred = self.predictor(planes)
        with torch.no_grad():
            tgt = self.target(planes)
        return torch.sum((pred - tgt) ** 2, dim=-1)


class EnsembleHeads(nn.Module):
    """``ensemble_size`` extra value heads over the detached core
    (net4_ensemble.rs:130-171): core [B, F, N, N] -> f32[B, E]."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.heads = nn.ModuleList(ScalarHead(cfg, tanh=True) for _ in range(cfg.ensemble_size))
        self.eval()

    def forward(self, core):
        core = core.detach()
        return torch.stack([head(core) for head in self.heads], dim=-1)


@torch.no_grad()
def _init_weights(module: nn.Module, seed: int) -> nn.Module:
    """He-normal convs, LeCun-normal dense kernels and zero biases from a
    torch generator on the CPU (so the draw does not depend on the device);
    BatchNorm and LayerNorm keep their identity initialisation."""
    gen = torch.Generator().manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, (1.0 / mod.in_features) ** 0.5, generator=gen)
            mod.bias.zero_()
    return module.eval()


def init_network(cfg: NetConfig, seed: int = 0) -> TakNet:
    """A :class:`TakNet` with random weights (see :func:`_init_weights`)."""
    return _init_weights(TakNet(cfg), seed)


def init_rnd(cfg: NetConfig, seed: int = 0) -> RndPair:
    """An :class:`RndPair` with random weights; predictor and target are
    drawn one after the other from one generator, so they differ."""
    return _init_weights(RndPair(cfg), seed)


def init_ensemble(cfg: NetConfig, seed: int = 0) -> EnsembleHeads:
    return _init_weights(EnsembleHeads(cfg), seed)


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
    heads are copied (they have biases).  A bf16 network on a CUDA card also
    gets its convolutions packed for the kernel (``packed``, see
    :func:`_packed`)."""
    dt = cfg.compute_dtype
    head = lambda h: (h.conv.weight, h.conv.bias, h.dense.weight, h.dense.bias)  # noqa: E731
    fw = {
        "stem": _fold(net.core.stem, dt),
        "blocks": [(_fold(b.a, dt), _fold(b.b, dt)) for b in net.core.blocks],
        "policy": (net.policy.weight, net.policy.bias),
        "value": head(net.value),
        "ube": head(net.ube),
    }
    if _takes_kernel(dt, fw["stem"][0]):
        _packed(fw)
    return fw


def _takes_kernel(dtype, x: torch.Tensor) -> bool:
    """Whether the folded path runs its convolutions through ``ops/conv.py``'s
    kernel: bf16 on a CUDA card.  Float32 and the CPU keep :func:`_conv2d`."""
    return dtype == torch.bfloat16 and x.is_cuda


def _packed(fw: dict) -> dict:
    """``fw["packed"]``: the kernel's packed layers, made once per fold and
    kept, so that CUDA graphs captured around the evaluator see the same
    weight tensors on every replay (a refold makes new ones)."""
    if "packed" not in fw:
        fw["packed"] = conv.pack_folded(fw)
    return fw["packed"]


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


def _dense_head(h: torch.Tensor, w, tanh: bool) -> torch.Tensor:
    """A scalar head's dense layer in float32 on its relued map h f32[B, n n]."""
    _, _, dk, db = w
    out = (h @ dk.float().t() + db.float())[:, 0]
    return torch.tanh(out) if tanh else out


def apply_packed(cfg: NetConfig, fw: dict, planes: torch.Tensor, with_core: bool = False):
    """:func:`apply_folded` through ``ops/conv.py``: one ``conv3x3`` a layer,
    the activations NHWC bf16 from the stem to the core, the value and UBE
    maps from the policy launch.  The kernel on a CUDA card; on CPU tensors
    ``conv3x3`` is its plain version.  ``with_core``'s core is an NCHW view
    of the NHWC tower output."""
    packed = _packed(fw)
    x = conv.conv3x3(planes.contiguous(), packed["stem"])
    for a, b in packed["blocks"]:
        x = conv.conv3x3(conv.conv3x3(x, a), b, residual=x)
    policy, heads = conv.conv3x3(x, packed["head"])
    out = (policy, _dense_head(heads[:, 0], fw["value"], True), _dense_head(heads[:, 1], fw["ube"], False))
    return out + (x[..., : cfg.filters].permute(0, 3, 1, 2),) if with_core else out


@torch.no_grad()
def apply_folded(cfg: NetConfig, fw: dict, planes: torch.Tensor, with_core: bool = False):
    """Inference on folded weights: (policy f32[B,A], value f32[B], ube f32[B]).

    ``with_core`` appends the residual tower's output (``compute_dtype``
    [B, F, N, N]) so that extra heads (the ensemble) reuse this forward
    instead of running a second tower.  In bf16 on a CUDA card the
    convolutions run as ``ops/conv.py``'s kernel (:func:`apply_packed`)."""
    dt = cfg.compute_dtype
    if _takes_kernel(dt, planes):
        return apply_packed(cfg, fw, planes, with_core)
    with conv_precision(dt):
        x = F.relu(_conv2d(planes, *fw["stem"], dt)).to(dt)
        for (k1, b1), (k2, b2) in fw["blocks"]:
            y = F.relu(_conv2d(x, k1, b1, dt)).to(dt)
            y = _conv2d(y, k2, b2, dt)
            x = F.relu(x.float() + y).to(dt)
        core = x
        policy = _conv2d(core, *fw["policy"], dt).flatten(1)

        def scalar_head(w, tanh):
            return _dense_head(F.relu(_conv2d(core, w[0], w[1], dt)).flatten(1), w, tanh)

        out = (policy, scalar_head(fw["value"], True), scalar_head(fw["ube"], False))
        return out + (core,) if with_core else out
