"""Plain PyTorch reference of the evaluator: input planes, the ResNet with
its BatchNorm unfolded, the SimHash seen-set lookup and net5's MLP RND.

Written from the reference implementation's network files
(takzero/src/network/net6_simhash.rs, net5.rs, repr.rs): per side, the
side to move first, three top-piece planes (flat, wall, cap) and 2N
planes of the pieces under the top; then the side to move's and the
opponent's stone and cap reserves as shares of the start, a side-to-move
plane and the flat difference less half the komi over N*N.  A 3x3 stem
conv + BN + relu, ``blocks`` residual blocks of two 3x3 conv + BN, a 3x3
policy conv (channel-major logits), and value / UBE heads of a 1x1 conv,
relu and a dense layer (tanh on the value).  The novelty variance is
``clip(max(exp(ube), novelty), 0, 4)``: SimHash gives 4 to a position
whose bucket is not in the seen-set and 0 otherwise; RND gives its
min/max-normalised error scaled to [0, 4].

Everything runs in float32 with TF32 off, or, for the control, with every
operand and result of a convolution or a dense layer rounded to float8
e4m3 under a per-tensor scale.  Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import tak

BN_EPS = 1e-5
RND_WIDTHS = (1024, 1024, 512)
MAX_VARIANCE = 4.0
FP8_MAX = 448.0


def input_channels(n: int) -> int:
    return 4 * n + 12


def num_channels(n: int) -> int:
    return 3 + 4 * (2**n - 2)


def num_actions(n: int) -> int:
    return num_channels(n) * n * n


# ---------------------------------------------------------------------------
# Parameters: names and shapes (the program's module names, so that the
# harness can load the same tensors into the program)
# ---------------------------------------------------------------------------


def net_spec(cfg: dict) -> list:
    """``(name, shape, kind)`` of every tensor of the network; kind is
    ``w`` or ``w_abs`` (conv or dense weight), ``b`` (bias), ``bn`` (a BatchNorm's
    ``weight``, ``bias``, ``running_mean`` or ``running_var``) or
    ``count`` (BatchNorm's ``num_batches_tracked``)."""
    n, f = cfg["n"], cfg["filters"]
    out = []

    def convbn(prefix, cin, cout, gain):
        out.append((f"{prefix}.conv.weight", (cout, cin, 3, 3), ("w", 2.0)))
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out.append((f"{prefix}.bn.{leaf}", (cout,), ("bn", leaf, gain)))
        out.append((f"{prefix}.bn.num_batches_tracked", (), ("count",)))

    convbn("core.stem", input_channels(n), f, 1.0)
    for i in range(cfg["blocks"]):
        convbn(f"core.blocks.{i}.a", f, f, 1.0)
        convbn(f"core.blocks.{i}.b", f, f, cfg["residual_gain"])
    out.append(("policy.weight", (num_channels(n), f, 3, 3), ("w", cfg["policy_gain"])))
    out.append(("policy.bias", (num_channels(n),), ("b",)))
    for head in ("value", "ube"):
        out.append((f"{head}.conv.weight", (1, f, 1, 1), ("w_abs", 1.0)))
        out.append((f"{head}.conv.bias", (1,), ("b",)))
        out.append((f"{head}.dense.weight", (1, n * n), ("w", cfg["head_gain"])))
        out.append((f"{head}.dense.bias", (1,), ("b",)))
    return out


def rnd_spec(cfg: dict) -> list:
    """The MLP RND's predictor and target (net5.rs:122-148)."""
    dims = (input_channels(cfg["n"]) * cfg["n"] ** 2,) + RND_WIDTHS
    out = []
    for side in ("predictor", "target"):
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            out.append((f"{side}.layers.{i}.weight", (b, a), ("w", 1.0)))
            out.append((f"{side}.layers.{i}.bias", (b,), ("b",)))
    return out


def make_params(spec: list, gen: torch.Generator, device) -> dict:
    """Random tensors for ``spec`` from ``gen``, in two draws on ``device``.

    Weights are normal with variance ``gain / fan_in`` (``gain`` 2 for the
    3x3 convolutions of the tower, whose inputs pass a relu), biases small
    normals; each BatchNorm gets a scale in [0.8, 1.2] times its gain, a
    shift, mean and variance near 0, 0 and 1, so that folding them into
    the convolutions is not the identity.  The second BatchNorm of a block
    carries ``residual_gain``, which keeps the activations of the
    residual tower of order one at any depth; ``head_gain`` keeps the
    value and UBE heads off tanh's and the variance clip's flat ends, and
    their 1x1 convolutions (``w_abs``) have positive weights, so that the
    relu after them, over the tower's nonnegative output, is never dead.
    """
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        z, u = normal[at : at + size].view(shape), uniform[at : at + size].view(shape)
        at += size
        if kind[0] in ("w", "w_abs"):
            z = z.abs() if kind[0] == "w_abs" else z
            out[name] = z * (kind[1] / int(np.prod(shape[1:]))) ** 0.5
        elif kind[0] == "b":
            out[name] = 0.05 * z
        elif kind[0] == "bn":
            leaf, gain = kind[1], kind[2]
            out[name] = {"weight": (0.8 + 0.4 * u) * gain, "bias": 0.05 * z,
                         "running_mean": 0.1 * (u.flip(0) - 0.5), "running_var": 0.8 + 0.4 * u.flip(0)}[leaf]
        else:
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return out


# ---------------------------------------------------------------------------
# Input planes
# ---------------------------------------------------------------------------


def planes(positions: list, half_komi: int) -> torch.Tensor:
    """float32 [B, C, N, N] input planes of ``positions`` (reference
    :class:`tak.Position`), on the CPU."""
    n = positions[0].n
    s = n * n
    stones0, caps0 = tak.RESERVES[n]
    out = np.zeros((len(positions), input_channels(n), s), np.float32)
    per_side = 3 + 2 * n
    for b, p in enumerate(positions):
        me = p.to_move
        for side_i, side in enumerate((me, 1 - me)):
            base = side_i * per_side
            for sq, stack in enumerate(p.stacks):
                if not stack:
                    continue
                if stack[-1] == side:
                    out[b, base + p.tops[sq] - 1, sq] = 1.0
                for depth in range(1, 2 * n + 1):
                    if len(stack) > depth and stack[len(stack) - 1 - depth] == side:
                        out[b, base + 2 + depth, sq] = 1.0
        f32 = np.float32
        res = p.reserves
        ratio = lambda v, full: f32(v) / f32(full) if full else f32(0.0)  # noqa: E731
        scalars = (
            ratio(res[me][0], stones0), ratio(res[me][1], caps0),
            ratio(res[1 - me][0], stones0), ratio(res[1 - me][1], caps0),
            f32(1.0 if me == 1 else 0.0),
            (f32(tak.flat_diff(p)) - f32(half_komi / 2.0)) / f32(s),
        )
        for i, v in enumerate(scalars):
            out[b, 2 * per_side + i, :] = v
    return torch.from_numpy(out).reshape(len(positions), input_channels(n), n, n)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matmuls and convolutions inside."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _identity(t):
    return t


def _bn(x, p, prefix):
    g = p[f"{prefix}.bn.weight"] / torch.sqrt(p[f"{prefix}.bn.running_var"] + BN_EPS)
    return (x - p[f"{prefix}.bn.running_mean"][None, :, None, None]) * g[None, :, None, None] \
        + p[f"{prefix}.bn.bias"][None, :, None, None]


def _conv(x, w, bias, q):
    y = q(F.conv2d(q(x), q(w), padding=w.shape[-1] // 2))
    return y if bias is None else y + bias[None, :, None, None]


def _dense(x, w, bias, q):
    return q(q(x) @ q(w).t()) + bias


def tower_and_heads(p: dict, x: torch.Tensor, blocks: int, q=_identity):
    """(logits [B, A], value [B], ube [B]) of the network ``p`` on planes ``x``."""
    h = F.relu(_bn(_conv(x, p["core.stem.conv.weight"], None, q), p, "core.stem"))
    for i in range(blocks):
        a, b = f"core.blocks.{i}.a", f"core.blocks.{i}.b"
        y = F.relu(_bn(_conv(h, p[f"{a}.conv.weight"], None, q), p, a))
        y = _bn(_conv(y, p[f"{b}.conv.weight"], None, q), p, b)
        h = F.relu(h + y)
    logits = _conv(h, p["policy.weight"], p["policy.bias"], q).flatten(1)

    def head(name):
        z = F.relu(_conv(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], q)).flatten(1)
        return _dense(z, p[f"{name}.dense.weight"], p[f"{name}.dense.bias"], q)[:, 0]

    return logits, torch.tanh(head("value")), head("ube")


def simhash_indices(x: torch.Tensor, matrix: torch.Tensor, with_doubt: bool = False):
    """int64[B] buckets: bit i set where the planes, side-to-move plane
    zeroed and flattened channel-major, project onto column i at >= 0
    (float64 dots).  ``with_doubt`` also returns int64[B] masks of the bits
    whose sign a float32 sum in some order could turn: a dot within
    ``k * 2^-24 / (1 - k * 2^-24)`` of the sum of its ``k`` nonzero terms'
    magnitudes.  A bucket with any of those bits flipped is as right."""
    c = x.shape[1]
    x = x.clone()
    x[:, c - 2] = 0.0
    flat = x.reshape(x.shape[0], -1).double()
    dots = flat @ matrix.double()
    shifts = torch.arange(matrix.shape[1], device=x.device)
    idx = ((dots >= 0).to(torch.int64) << shifts).sum(-1)
    if not with_doubt:
        return idx
    k = (flat != 0).sum(-1, keepdim=True).double() * 2.0**-24
    bound = k / (1 - k) * (flat.abs() @ matrix.double().abs())
    return idx, ((dots.abs() <= bound).to(torch.int64) << shifts).sum(-1)


def candidates(idx: int, doubt: int) -> list:
    """``idx`` with every subset of the ``doubt`` bits flipped."""
    bits = [1 << b for b in range(64) if doubt >> b & 1]
    out = [idx]
    for bit in bits:
        out += [c ^ bit for c in out]
    return out


def seen(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bool[B]: is bit ``idx`` of the seen-set set (uint32 words held as
    int32, bit ``idx & 31`` of word ``idx >> 5``)."""
    w = words[idx >> 5].to(torch.int64) & 0xFFFFFFFF
    return ((w >> (idx & 31)) & 1) == 1


def rnd_error(p: dict, x: torch.Tensor, q=_identity) -> torch.Tensor:
    """f32[B] squared error between the MLP RND's predictor and target."""
    z = x.flatten(1)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)

    def mlp(side):
        h = z
        for i in range(len(RND_WIDTHS)):
            h = F.relu(_dense(h, p[f"{side}.layers.{i}.weight"], p[f"{side}.layers.{i}.bias"], q))
        return h

    return torch.sum((mlp("predictor") - mlp("target")) ** 2, dim=-1)


def evaluate(cfg: dict, weights: dict, positions: list, device, q=_identity, block: int = 256) -> dict:
    """The reference evaluator on ``positions``, in blocks of ``block``
    rows: numpy ``logits`` [B, A], ``value`` [B], ``std`` [B] (the square
    root of the variance), ``novelty`` [B]; under SimHash ``std_alt``, the
    std with the other seen-set answer where float32 rounding could move a
    bucket (``std`` elsewhere), and whether seen and unseen are possible."""
    out = {"logits": [], "value": [], "std": [], "std_alt": [], "novelty": [], "seen_possible": [],
           "unseen_possible": []}
    with strict_float32(), torch.no_grad():
        for i in range(0, len(positions), block):
            x = planes(positions[i : i + block], cfg["half_komi"]).to(device)
            logits, value, ube = tower_and_heads(weights["net"], x, cfg["blocks"], q)
            alt = None
            if cfg["novelty"] == "simhash":
                idx, doubt = simhash_indices(x, weights["hash_matrix"], with_doubt=True)
                known = seen(weights["seen_set"], idx)
                novelty = torch.where(known, 0.0, MAX_VARIANCE)
                # Where float32 rounding could move the bucket, either
                # answer of the seen-set is right.
                can_seen, can_unseen = known.clone(), ~known
                for r in torch.nonzero(doubt).flatten().tolist():
                    alts = torch.tensor(candidates(int(idx[r]), int(doubt[r])), device=idx.device)
                    hits = seen(weights["seen_set"], alts)
                    can_seen[r], can_unseen[r] = bool(hits.any()), bool((~hits).any())
                alt = torch.where(known & can_unseen, MAX_VARIANCE, torch.where(~known & can_seen, 0.0, novelty))
            elif cfg["novelty"] == "rnd":
                lo, hi = weights["rnd_bounds"]
                err = rnd_error(weights["rnd"], x, q)
                novelty = torch.clamp((err - lo) / max(hi - lo, 1e-8), 0.0, 1.0) * MAX_VARIANCE
            else:
                raise ValueError(f"no reference for novelty {cfg['novelty']!r}")
            std_of = lambda nov: torch.sqrt(torch.clamp(torch.maximum(torch.exp(ube), nov), 0.0, MAX_VARIANCE))  # noqa: E731
            out["logits"].append(logits.cpu())
            out["value"].append(value.cpu())
            out["std"].append(std_of(novelty).cpu())
            out["std_alt"].append(std_of(novelty if alt is None else alt).cpu())
            out["novelty"].append(novelty.cpu())
            out["seen_possible"].append(((novelty == 0) if alt is None else can_seen).cpu())
            out["unseen_possible"].append(((novelty > 0) if alt is None else can_unseen).cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}
