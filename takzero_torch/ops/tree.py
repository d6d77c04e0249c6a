"""The search's descent, settle and backup as CUDA kernels, one block a tree.

They replace no TPU kernel: JAX runs both walks as batched loops
(``takzero_tpu/search/core.py`` ``forward`` :101, ``backward`` :430) and
fuses the forward's tail (the leaf's ``step`` and ``terminal_kind``), as the
port does with batched operators on the CPU (``search/core.py`` ``descend``,
``settle`` and ``backward``).  On a CUDA tree those launch these kernels
(``takzero_torch/csrc/tree.cu``, ``csrc/settle.cu``): each lane of the batch
walks its own path and settles its own leaf, so a lane gets a thread block
(a child slot a thread in the walks, a square a thread in the settle), and a
simulation runs on the card with no host read (it can then be captured whole
in CUDA graphs).  Their per-lane algorithm, in plain torch, is
``search/lanewise.py`` (``descend_plain``, ``settle_plain``,
``backup_plain``); the float work repeats the batched loops' torch operators
on the card and the settle's is integer, so the trees are the batched
path's bit for bit.

At [128 lanes, C = 256] a level reads a node's row of seven arrays, about
8 KB a lane; budget 384 from fresh openings walks 5-6 levels: about 6 MB,
1.8 us at 3.35 TB/s.  The levels are dependent, so latency, not bytes, sets
the time.  The settle moves about 0.2 MB at [128, 6x6].  Their launches
count under ``tree_descend``, ``tree_settle`` and ``tree_backup``
(``_build.launch_counts``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..tak.state import TakState
from . import _build

MODES = {"all": 0, "known": 1, "leaf": 2}
MAX_CHILDREN = 1024  # one thread a child slot

_TREE_DTYPES = dict(
    child_action=torch.int32, child_flag=torch.int32, child_ply=torch.int32, child_value=torch.float32,
    child_prob=torch.float32, child_std=torch.float32, child_visit=torch.int32, child_node=torch.int32,
    node_incomplete=torch.bool, root_visit=torch.int32, root_flag=torch.int32, root_ply=torch.int32,
    root_value=torch.float32, root_std=torch.float32,
)


def _check_tree(tree) -> tuple:
    """(b, m, c) of a CUDA tree whose arrays the kernels can take."""
    b, m, c = tree.child_visit.shape
    dev = tree.child_visit.device
    if dev.type != "cuda":
        raise ValueError(f"tree kernels: the tree is on {dev}; the CPU runs the batched loops")
    if not 0 < c <= MAX_CHILDREN:
        raise ValueError(f"tree kernels: need 0 < C <= {MAX_CHILDREN}, got C={c}")
    for name, dtype in _TREE_DTYPES.items():
        x = getattr(tree, name)
        if x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"tree kernels: {name} must be contiguous {dtype} on {dev}, "
                             f"got {x.dtype} on {x.device} contiguous={x.is_contiguous()}")
    return b, m, c


def _lane_tensor(x: torch.Tensor, dtype, b: int, dev) -> torch.Tensor:
    """``x`` as a contiguous ``dtype``[b] on ``dev`` (no copy where it is one)."""
    x = x.to(device=dev, dtype=dtype)
    if x.shape != (b,):
        raise ValueError(f"tree kernels: expected a [{b}] tensor, got {tuple(x.shape)}")
    return x.contiguous()


def tree_descend(tree, beta: torch.Tensor, forced_slot, skip_root: bool, max_depth: int, out: dict) -> dict:
    """The descent of every lane, written into ``out`` (the fields of
    ``search/core.py`` ``_descent_buffers``), and the root's visit added
    unless ``skip_root``.  ``beta`` f32[B] (an expanded scalar too);
    ``forced_slot`` [B] or None: the slot taken at depth 0."""
    b, m, c = _check_tree(tree)
    dev = tree.child_visit.device
    if beta.dtype != torch.float32 or beta.device != dev or beta.shape != (b,) or beta.stride(0) not in (0, 1):
        raise ValueError(f"tree_descend: beta must be f32[{b}] on {dev} with stride 0 or 1")
    forced = None if forced_slot is None else _lane_tensor(forced_slot, torch.int64, b, dev)
    if out["path_node"].shape != (b, max_depth):
        raise ValueError(f"tree_descend: the path must be [{b}, {max_depth}]")
    if b:
        with torch.cuda.device(dev):
            _build.launch(
                "tree", "tree_descend_launch",
                tree.child_action.data_ptr(), tree.child_flag.data_ptr(), tree.child_ply.data_ptr(),
                tree.child_value.data_ptr(), tree.child_prob.data_ptr(), tree.child_std.data_ptr(),
                tree.child_visit.data_ptr(), tree.child_node.data_ptr(), tree.root_flag.data_ptr(),
                tree.root_visit.data_ptr(), beta.data_ptr(), None if forced is None else forced.data_ptr(),
                *(out[k].data_ptr() for k in ("lane_root_expand", "cur", "cur_flag", "active", "path_node",
                                               "path_slot", "length", "stop_known", "known_f", "known_p",
                                               "known_v", "stop_leaf", "leaf_parent", "leaf_slot")),
                b, m, c, max_depth, int(skip_root), beta.stride(0), torch.cuda.current_stream().cuda_stream,
            )
    return out


def tree_backup(tree, rec: dict, v_net: torch.Tensor, var_net: torch.Tensor, skip_root: bool,
                mode: str = "all") -> None:
    """The backup of every lane that ``mode`` selects ("all": known stops
    and evaluated leaves; "known"; "leaf"), in place, each from its own
    path length down to the root (to depth 1 under ``skip_root``)."""
    b, m, c = _check_tree(tree)
    dev = tree.child_visit.device
    if mode not in MODES:
        raise ValueError(f"tree_backup: unknown mode {mode!r}")
    path_node, path_slot = (rec[k].to(torch.int32).contiguous() for k in ("path_node", "path_slot"))
    if path_node.shape != path_slot.shape or path_node.dim() != 2 or path_node.shape[0] != b:
        raise ValueError(f"tree_backup: the path must be [{b}, depth], got {tuple(path_node.shape)}")
    lanes = [_lane_tensor(rec[k], dtype, b, dev) for k, dtype in (
        ("length", torch.int32), ("stop_known", torch.bool), ("known_f", torch.int32),
        ("known_p", torch.int32), ("known_v", torch.float32), ("lane_eval_leaf", torch.bool))]
    nets = [_lane_tensor(x, torch.float32, b, dev) for x in (v_net, var_net)]
    if b:
        with torch.cuda.device(dev):
            _build.launch(
                "tree", "tree_backup_launch",
                tree.child_action.data_ptr(), tree.child_flag.data_ptr(), tree.child_ply.data_ptr(),
                tree.child_value.data_ptr(), tree.child_std.data_ptr(), tree.child_visit.data_ptr(),
                tree.node_incomplete.data_ptr(), tree.root_visit.data_ptr(), tree.root_flag.data_ptr(),
                tree.root_ply.data_ptr(), tree.root_value.data_ptr(), tree.root_std.data_ptr(),
                path_node.data_ptr(), path_slot.data_ptr(), *(x.data_ptr() for x in lanes + nets),
                b, m, c, path_node.shape[1], int(skip_root), MODES[mode], torch.cuda.current_stream().cuda_stream,
            )


# The tensors of a settle, in ``csrc/settle.cu``'s ``Settle`` order: the
# tree's, the node pool's states', the descent's and the outputs'.
_SETTLE_TREE = ("child_action", "child_flag", "child_ply", "child_value", "child_std", "child_visit",
                "node_parent", "node_slot", "root_flag", "root_ply", "root_std", "overflow")
_SETTLE_LOOP = dict(lane_root_expand=torch.bool, cur=torch.int64, cur_flag=torch.int32, active=torch.bool,
                    path_node=torch.int32, path_slot=torch.int32, length=torch.int32, stop_known=torch.bool,
                    known_f=torch.int32, known_p=torch.int32, known_v=torch.float32, stop_leaf=torch.bool,
                    leaf_parent=torch.int64, leaf_slot=torch.int64)
_SETTLE_OUT = dict(length=torch.int32, stop_known=torch.bool, known_f=torch.int32, known_p=torch.int32,
                   known_v=torch.float32, lane_eval_leaf=torch.bool, lane_eval_root=torch.bool)
_STATE_DTYPES = TakState(height=torch.int32, owner=torch.int64, tops=torch.int32, reserves=torch.int32,
                         to_move=torch.int32, ply=torch.int32, reversible=torch.int32)


def _state_shapes(s: int) -> TakState:
    """The shapes of one Tak state's fields over ``s`` squares."""
    return TakState((s,), (s,), (s,), (2, 2), (), (), ())


def tree_settle(tree, loop: dict, eng, max_depth: int) -> dict:
    """``search/core.py`` ``settle`` of every lane for a Tak engine ``eng``:
    the depth clip, the path's visits, the leaf's state and its terminal
    kind and the terminal stores, in place in ``tree``.  ``loop`` holds the
    descent's outputs (``_descent_buffers``' fields, the path [B,
    ``max_depth``]).  Returns ``settle``'s dict: the loop's path, leaf edge
    and root-expansion lanes, and new tensors for the rest (the evaluated
    states ``env_eval`` among them)."""
    b, m, c = _check_tree(tree)
    dev = tree.child_visit.device
    env = tree.node_env
    s = env.height.shape[-1]
    n = math.isqrt(s)
    if n * n != s or not 3 <= n <= 8 or n != eng.n:
        raise ValueError(f"tree_settle: needs an engine's n x n board with 3 <= n <= 8, got {s} squares "
                         f"for n={eng.n}")
    checks = [(f"tree.{name}", getattr(tree, name), torch.int32, getattr(tree, name).shape)
              for name in ("node_parent", "node_slot", "overflow")]
    checks += [(f"node_env.{name}", x, dtype, (b, m, *shape)) for name, x, dtype, shape in zip(
        env._fields, env, _STATE_DTYPES, _state_shapes(s))]
    checks += [(name, loop[name], dtype, (b, max_depth) if name.startswith("path_") else (b,))
               for name, dtype in _SETTLE_LOOP.items()]
    for name, x, dtype, shape in checks:
        if x.dtype != dtype or x.device != dev or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"tree_settle: {name} must be contiguous {dtype}{list(shape)} on {dev}, "
                             f"got {x.dtype}{list(x.shape)} on {x.device}")
    out = {name: torch.empty((b,), dtype=dtype, device=dev) for name, dtype in _SETTLE_OUT.items()}
    env_eval = TakState(*(torch.empty((b, *shape), dtype=dtype, device=dev)
                          for shape, dtype in zip(_state_shapes(s), _STATE_DTYPES)))
    tensors = ([getattr(tree, name) for name in _SETTLE_TREE] + list(env) + [loop[name] for name in _SETTLE_LOOP]
               + list(out.values()) + list(env_eval))
    if b:
        pointers = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
        with torch.cuda.device(dev):
            _build.launch("settle", "tree_settle_launch", pointers, b, m, c, n, max_depth, eng.half_komi,
                          eng.reversible_limit, torch.cuda.current_stream().cuda_stream)
    return dict(
        path_node=loop["path_node"], path_slot=loop["path_slot"], length=out["length"],
        stop_known=out["stop_known"], known_f=out["known_f"], known_p=out["known_p"], known_v=out["known_v"],
        lane_eval_leaf=out["lane_eval_leaf"], lane_eval_root=out["lane_eval_root"],
        lane_root_expand=loop["lane_root_expand"], leaf_parent=loop["leaf_parent"], leaf_slot=loop["leaf_slot"],
        env_eval=env_eval,
    )
