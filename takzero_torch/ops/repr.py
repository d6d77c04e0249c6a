"""Network input planes for a batch of Tak states.

Counterpart of ``takzero_tpu/ops/repr.py`` (``state_to_planes``), written
out for a batch instead of ``vmap``: per side ("mine" first) the top-piece
one-hots and 2N carry planes, four reserve ratios, the side-to-move plane
and the flat-difference plane.  Output is ``[B, C, N, N]`` float32
(channel-major, which is also torch's NCHW).
"""

from __future__ import annotations

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
    stones_ratio = res[:, :, 0] / default_stones  # [B, 2]
    if default_caps:
        caps_ratio = res[:, :, 1] / default_caps
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
            (eng.flat_diff(state).to(torch.float32) - eng.half_komi / 2.0) / s,
        ],
        dim=1,
    )  # [B, 6]
    rest = scalars[:, :, None].expand(b, 6, s)
    planes = torch.cat([mine, opp, rest], dim=1)
    return planes.reshape(b, input_channels(n), n, n)
