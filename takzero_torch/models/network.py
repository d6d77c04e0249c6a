"""The Tak ResNet as torch modules, and its BN-folded inference path.

Counterpart of ``takzero_tpu/models/network.py``: a conv3x3+BN+relu stem,
``blocks`` residual blocks of ``filters`` channels, a conv3x3 policy head
flattened channel-major (the action-index layout, and NCHW's natural
flatten), and value/UBE heads conv1x1 -> relu -> flatten -> dense(1)
(tanh on the value).  Only inference is ported in this slice: the modules
run in eval mode (running BatchNorm statistics).

Numerics of the folded path follow ``apply_folded``: convolutions run in
``compute_dtype`` without bias, the f32 bias (and the residual) are added
in float32, and the result is cast back to ``compute_dtype`` where JAX
casts.  The JAX path keeps the bf16 convolution's f32 accumulator; a
torch bf16 convolution rounds its output to bf16 before the bias add, so
bf16 outputs differ from JAX's by a few bf16 ulps (the tests state the
tolerance).  In float32 the two agree to float rounding.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.repr import input_channels, input_size
from ..tak.moves import action_space

MAXIMUM_VARIANCE = 4.0  # value span is [-1, 1] -> variance <= 2^2
_BN_EPS = 1e-5


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


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)

    def forward(self, x):
        return self.bn(self.conv(x))


class ResBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.a = ConvBN(filters, filters)
        self.b = ConvBN(filters, filters)

    def forward(self, x):
        return F.relu(x + self.b(F.relu(self.a(x))))


class Core(nn.Module):
    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.stem = ConvBN(input_channels(cfg.n), cfg.filters)
        self.blocks = nn.ModuleList(ResBlock(cfg.filters) for _ in range(cfg.blocks))

    def forward(self, x):
        x = F.relu(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        return x


class ScalarHead(nn.Module):
    """conv1x1 -> relu -> flatten -> dense(1); optional tanh."""

    def __init__(self, cfg: NetConfig, tanh: bool):
        super().__init__()
        self.tanh = tanh
        self.conv = nn.Conv2d(cfg.filters, 1, 1)
        self.dense = nn.Linear(cfg.n * cfg.n, 1)

    def forward(self, x):
        h = F.relu(self.conv(x)).flatten(1).float()
        out = self.dense(h)[:, 0]
        return torch.tanh(out) if self.tanh else out


class TakNet(nn.Module):
    """planes [B, C, N, N] -> (policy [B, A], value [B], ube [B]) in eval mode."""

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
        policy = self.policy(core).flatten(1).float()
        return policy, self.value(core), self.ube(core)


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
    """conv in ``dtype`` (no bias), then + f32 bias in float32."""
    pad = kernel.shape[-1] // 2
    y = F.conv2d(x.to(dtype), kernel.to(dtype), padding=pad)
    return y.float() + bias.float()[None, :, None, None]


@torch.no_grad()
def apply_folded(cfg: NetConfig, fw: dict, planes: torch.Tensor):
    """Inference on folded weights: (policy f32[B,A], value f32[B], ube f32[B])."""
    dt = cfg.compute_dtype
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
