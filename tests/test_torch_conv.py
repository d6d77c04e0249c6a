"""The evaluator's convolution layers (``takzero_torch/ops/conv.py``) on the CPU.

The card runs each convolution of the bf16 folded network as one kernel
launch from weights packed once per fold; its plain version,
``conv3x3_plain``, computes the same function from the same packed weights.
These tests hold the packing and the plain version to the present folded
path (``models/network.py`` ``_conv2d`` and ``apply_folded``), exactly in
float32: every operand is a small integer, exact in bf16, so every product
and every float32 sum is exact whatever the order of summation (the card's
kernel sums in another order than the CPU; ``tests/test_torch_cuda.py``
holds it to the plain version there).
"""

import pytest
import torch
import torch.nn.functional as F

from takzero_torch.models import network
from takzero_torch.ops import conv
from takzero_torch.ops.repr import input_channels
from takzero_torch.tak.moves import action_space

torch.set_num_threads(2)
BF16 = torch.bfloat16


def _ints(gen, shape, lo=-2, hi=3, density=1.0):
    x = torch.randint(lo, hi, shape, generator=gen).float()
    if density < 1.0:
        x = x * (torch.rand(shape, generator=gen) < density)
    return x


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _padded(x, c):
    """NHWC ``x`` with its channels zero-padded to ``c``, as the kernel's rows hold them."""
    return F.pad(x, (0, c - x.shape[-1])).contiguous()


@pytest.mark.parametrize("k,cin,cout", [(3, 256, 256), (3, 36, 256), (3, 16, 16), (3, 256, 253), (1, 64, 1)])
def test_pack_weight_round_trip(k, cin, cout):
    """``unpack_weight(pack_weight(w))`` is ``w`` rounded to bf16, placed at
    the centre of a 3x3 when 1x1 and zero-padded to multiples of 64; each
    packed row holds one tap's 64 channels with chunk c at ``c ^ (row % 8)``."""
    gen = torch.Generator().manual_seed(k + cin + cout)
    w = torch.randn(cout, cin, k, k, generator=gen)
    packed = conv.pack_weight(w)
    pad_in, pad_out = -(-cin // 64) * 64, -(-cout // 64) * 64
    assert packed.dtype == BF16 and packed.shape == (9 * pad_in // 64, pad_out, 64) and packed.is_contiguous()
    want = torch.zeros(pad_out, pad_in, 3, 3, dtype=BF16)
    o = (3 - k) // 2
    want[:cout, :cin, o:o + k, o:o + k] = w.to(BF16)
    assert torch.equal(conv.unpack_weight(packed), want)
    row, kb = 13, 9 + 4  # channel block 1, tap 4 (the centre), when there is one
    if pad_in >= 128:
        chunks = want[row, 64:128, 1, 1].reshape(8, 8)
        assert torch.equal(packed[kb, row].reshape(8, 8), chunks[torch.arange(8) ^ (row % 8)])


@pytest.mark.parametrize("kind", ["stem", "tower", "tower_residual", "head"])
@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_plain_layer_equals_the_folded_path(n, kind):
    """One layer of ``conv3x3_plain`` on packed weights against
    ``_conv2d`` and the epilogue ``apply_folded`` applies: the stem on the
    float32 planes (4n+12 channels, padded to 64), a tower layer without
    and with the residual (96 filters, padded to 128), and the head (the
    policy's channels flattened channel-major, the value and UBE 1x1 maps
    relued)."""
    gen = torch.Generator().manual_seed(10 * n + len(kind))
    b, filters = 2, 96
    cpad = 128
    if kind == "stem":
        c = input_channels(n)
        planes = _ints(gen, (b, c, n, n), 0, 2)
        k, bias = _ints(gen, (filters, c, 3, 3)).to(BF16), _ints(gen, (filters,))
        want = F.relu(network._conv2d(planes, k, bias, BF16)).to(BF16)
        got = conv.conv3x3_plain(planes, conv._layer(k, bias))
        assert got.shape == (b, n, n, cpad)
        assert torch.equal(got[..., :filters], _nhwc(want))
        assert not got[..., filters:].any()
        return
    x = _ints(gen, (b, filters, n, n)).to(BF16)
    if kind == "head":
        a = action_space(n).num_channels
        pk, pb = _ints(gen, (a, filters, 3, 3)), _ints(gen, (a,))
        vk, vb = _ints(gen, (1, filters, 1, 1)), _ints(gen, (1,))
        uk, ub = _ints(gen, (1, filters, 1, 1)), _ints(gen, (1,))
        layer = conv.pack_folded({"policy": (pk, pb), "value": (vk, vb), "ube": (uk, ub),
                                  "stem": (pk[:1], pb[:1]), "blocks": []})["head"]
        policy, heads = conv.conv3x3_plain(_padded(_nhwc(x), cpad), layer)
        assert torch.equal(policy, network._conv2d(x, pk, pb, BF16).flatten(1))
        assert policy.shape == (b, a * n * n) and heads.shape == (b, 2, n * n)
        for i, (ck, cb) in enumerate(((vk, vb), (uk, ub))):
            assert torch.equal(heads[:, i], F.relu(network._conv2d(x, ck, cb, BF16)).flatten(1))
        return
    k, bias = _ints(gen, (filters, filters, 3, 3)).to(BF16), _ints(gen, (filters,))
    layer = conv._layer(k, bias)
    y = network._conv2d(x, k, bias, BF16)
    if kind == "tower":
        want, residual = F.relu(y).to(BF16), None
    else:
        res = _ints(gen, (b, filters, n, n)).to(BF16)
        want, residual = F.relu(res.float() + y).to(BF16), _padded(_nhwc(res), cpad)
    got = conv.conv3x3_plain(_padded(_nhwc(x), cpad), layer, residual)
    assert torch.equal(got[..., :filters], _nhwc(want))
    assert not got[..., filters:].any()


def _integer_fold(cfg, gen):
    """``fold_inference_params`` of a fresh net with every kernel and bias
    replaced by small sparse integers, so that the whole tower's float32
    sums are exact integers in any order."""
    fw = network.fold_inference_params(cfg, network.init_network(cfg, 0))
    conv_ints = lambda w: _ints(gen, w.shape, -1, 2, density=0.15).to(w.dtype)  # noqa: E731
    bias_ints = lambda v: _ints(gen, v.shape, -1, 2)  # noqa: E731
    fw["stem"] = (conv_ints(fw["stem"][0]), bias_ints(fw["stem"][1]))
    fw["blocks"] = [tuple((conv_ints(k), bias_ints(v)) for k, v in pair) for pair in fw["blocks"]]
    fw["policy"] = (conv_ints(fw["policy"][0]), bias_ints(fw["policy"][1]))
    for head in ("value", "ube"):
        ck, cb, dk, db = fw[head]
        fw[head] = (conv_ints(ck), bias_ints(cb), bias_ints(dk), bias_ints(db))
    return fw


@pytest.mark.parametrize("n,filters", [(3, 16), (4, 64), (5, 96), (6, 64), (7, 32), (8, 64)])
def test_apply_packed_plain_equals_apply_folded(n, filters):
    """The whole bf16 folded path through ``apply_packed`` on CPU tensors,
    where ``conv3x3`` is ``conv3x3_plain`` (the card's chain of layers,
    NHWC from the stem to the core, the heads' 1x1 maps from the policy
    launch) equals ``apply_folded`` on the CPU exactly, and
    ``with_core``'s core is an NCHW view of the NHWC rows with the CPU's
    values; the fold on the CPU packs nothing."""
    cfg = network.NetConfig(n=n, filters=filters, blocks=2)
    gen = torch.Generator().manual_seed(n)
    fw = _integer_fold(cfg, gen)
    assert "packed" not in fw
    planes = _ints(gen, (3, input_channels(n), n, n), 0, 2)
    want = network.apply_folded(cfg, fw, planes, with_core=True)
    with torch.no_grad():
        got = network.apply_packed(cfg, fw, planes, with_core=True)
    assert "packed" in fw
    for g, w, what in zip(got, want, ("policy", "value", "ube", "core")):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        assert torch.equal(g, w), what
    assert got[3].stride(1) == 1  # channels innermost: a view of the NHWC rows


@pytest.mark.parametrize("m,cout_pad,tile", [
    (128 * 36, 256, (128, 128)),  # net6_simhash's tower at 128 rows: 72 tiles
    (128 * 25, 256, (64, 128)),  # net5's: 50 tiles of 128 rows would leave most SMs idle
    (64 * 36, 256, (64, 128)),  # a world-2 rank's 64 rows, had it not the global shape
    (36, 256, (64, 128)),  # TEI's single position
    (128 * 16, 64, (64, 64)),  # 4x4 at 64 filters
    (128 * 64, 192, (64, 64)),  # 8x8 at 192 filters: 64-column tiles
    (128 * 64, 1024, (128, 128)),  # 8x8's policy head
])
def test_choose_tile(m, cout_pad, tile):
    assert conv.choose_tile(m, cout_pad) == tile


def test_conv3x3_on_the_cpu_is_the_plain_version_and_checks_its_operands():
    gen = torch.Generator().manual_seed(1)
    layer = conv._layer(_ints(gen, (64, 64, 3, 3)), _ints(gen, (64,)))
    x = _ints(gen, (2, 5, 5, 64)).to(BF16)
    assert torch.equal(conv.conv3x3(x, layer), conv.conv3x3_plain(x, layer))
    with pytest.raises(ValueError, match="the stem takes 64 planes"):
        conv.conv3x3(x.float(), layer)
    with pytest.raises(ValueError, match="bf16 NHWC"):
        conv.conv3x3(x[..., :32].contiguous(), layer)
    with pytest.raises(ValueError, match="residual"):
        conv.conv3x3(x, layer, residual=x[:1].contiguous())
