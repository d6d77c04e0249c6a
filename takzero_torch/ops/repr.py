"""Network input planes for a batch of Tak states, and dense policy targets.

Counterpart of ``takzero_tpu/ops/repr.py``.  ``state_to_planes`` is
written out for a batch instead of ``vmap``: per side ("mine" first) the
top-piece one-hots and 2N carry planes, four reserve ratios, the
side-to-move plane and the flat-difference plane.  Output is
``[B, C, N, N]`` float32 (channel-major, which is also torch's NCHW).
``scatter_policy`` builds a batch's dense policy and legality mask on the
device from sparse triples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tak.engine import TakEngine
from ..tak.moves import DEFAULT_RESERVES
from ..tak.state import TakState, get_bit


def stack_size(n: int) -> int:
    return 2 * n + 3


def input_channels(n: int) -> int:
    return 2 * (stack_size(n) + 2) + 2


def input_size(n: int) -> int:
    return input_channels(n) * n * n


def state_to_planes(eng: TakEngine, state: TakState) -> torch.Tensor:
    """[B, input_channels, N, N] float32 planes for a batch of states."""
    n = eng.n
    b = state.height.shape[0]
    dev = state.height.device
    me = state.to_move.long()
    h = state.height
    tc = eng.top_color(state)  # [B, S]

    depth = torch.arange(1, stack_size(n) - 2, device=dev)  # 1..2N
    exists = h[:, None, :] > depth[None, :, None]  # [B, D, S]
    pos = (h[:, None, :] - 1 - depth[None, :, None]).clamp(min=0)
    col = get_bit(state.owner[:, None, :], pos)  # [B, D, S]

    def side_planes(color):  # color [B]
        c = color[:, None]
        top = [
            ((state.tops == j + 1) & (tc == c) & (h > 0)).to(torch.float32)
            for j in range(3)
        ]
        carry = (exists & (col == c[:, :, None])).to(torch.float32)
        return torch.cat([torch.stack(top, dim=1), carry], dim=1)  # [B, ss, S]

    mine = side_planes(me)
    opp = side_planes(1 - me)

    default_stones, default_caps = DEFAULT_RESERVES[n]
    res = state.reserves.to(torch.float32)
    # Every divisor is a tensor on the device: PyTorch's CUDA kernel turns a
    # division by a Python number into a product with its reciprocal, 1 ulp
    # off the division (the CPU's, JAX's) for some operands, and the LCG
    # hash reads the planes' bits.
    divisor = lambda v: torch.full((), float(v), device=dev)  # noqa: E731
    stones_ratio = res[:, :, 0] / divisor(default_stones)  # [B, 2]
    if default_caps:
        caps_ratio = res[:, :, 1] / divisor(default_caps)
    else:
        caps_ratio = torch.zeros_like(stones_ratio)
    bar = torch.arange(b, device=dev)
    s = n * n
    scalars = torch.stack(
        [
            stones_ratio[bar, me],
            caps_ratio[bar, me],
            stones_ratio[bar, 1 - me],
            caps_ratio[bar, 1 - me],
            (me == 1).to(torch.float32),
            (eng.flat_diff(state).to(torch.float32) - eng.half_komi / 2.0) / divisor(s),
        ],
        dim=1,
    )  # [B, 6]
    rest = scalars[:, :, None].expand(b, 6, s)
    planes = torch.cat([mine, opp, rest], dim=1)
    return planes.reshape(b, input_channels(n), n, n)


def scatter_policy(t: int, a: int, rows, cols, probs, device="cpu"):
    """Dense (policy f32[t, A], mask bool[t, A]) from sparse COO triples.

    ``rows``, ``cols`` and ``probs`` are host arrays; only they travel to
    ``device`` (a few KB instead of the dense [t, A] pair), and each output
    is one ``index_put_`` there.  JAX pads the triples to power-of-two
    buckets to bound its recompilations; eager torch needs no padding.
    """
    r = torch.as_tensor(np.asarray(rows, np.int64)).to(device)
    c = torch.as_tensor(np.asarray(cols, np.int64)).to(device)
    p = torch.as_tensor(np.asarray(probs, np.float32)).to(device)
    policy = torch.zeros((t, a), dtype=torch.float32, device=device)
    mask = torch.zeros((t, a), dtype=torch.bool, device=device)
    policy.index_put_((r, c), p)
    mask.index_put_((r, c), torch.ones_like(r, dtype=torch.bool))
    return policy, mask
