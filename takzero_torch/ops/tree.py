"""The search's descent, settle, backup and expansion as CUDA kernels, one
block a tree.

They replace no TPU kernel: JAX runs both walks as batched loops
(``takzero_tpu/search/core.py`` ``forward`` :101, ``backward`` :430) and
fuses the forward's tail (the leaf's ``step`` and ``terminal_kind``) and
``apply_eval`` (:305, with the engine's ``legal_mask``), as the port does
with batched operators on the CPU (``search/core.py`` ``descend``,
``settle``, ``apply_eval`` and ``backward``).  On a CUDA tree those launch
these kernels (``takzero_torch/csrc/tree.cu``, ``csrc/settle.cu``,
``csrc/expand.cu``): each lane of the batch walks its own path, settles its
own leaf and expands it, so a lane gets a thread block (a child slot a
thread in the walks and the expansion's stores, a square a thread in the
settle, an action a thread in the legal mask), and a simulation runs on the
card with no host read (it can then be captured whole in CUDA graphs).
Kernel A picks the expansion's children between its two kernels.  Their
per-lane algorithm, in plain torch, is ``search/lanewise.py``
(``descend_plain``, ``settle_plain``, ``apply_eval_plain``,
``backup_plain``); the float work repeats the batched loops' torch
operators on the card in their order and the rest is integer, so the trees
are the batched path's bit for bit.

At [128 lanes, C = 256] a level reads a node's row of seven arrays, about
8 KB a lane; budget 384 from fresh openings walks 5-6 levels: about 6 MB,
1.8 us at 3.35 TB/s.  The levels are dependent, so latency, not bytes, sets
the time.  The settle moves about 0.2 MB at [128, 6x6], the expansion about
10 MB (the logits in, kernel A's input out, the new rows).  The settle and
the expansion pass their tensors as one table of pointers in the order of
the kernel's struct (:func:`_launch_table`), checked by one list of the
tree's arrays (:func:`_check_tree`).  Their launches count under
``tree_descend``, ``tree_settle``, ``expand_mask``, ``expand_store`` and
``tree_backup`` (``_build.launch_counts``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..tak.state import TakState
from . import _build

MODES = {"all": 0, "known": 1, "leaf": 2}
MAX_CHILDREN = 1024  # one thread a child slot

# Every tree array the kernels take (all but the node pool's states) and its
# dtype; its shape is [B, M, C] for a child array, [B, M] for a node's
# (_NODE_ARRAYS), else [B].
_TREE_DTYPES = dict(
    child_action=torch.int32, child_logit=torch.float32, child_prob=torch.float32, child_visit=torch.int32,
    child_flag=torch.int32, child_ply=torch.int32, child_value=torch.float32, child_std=torch.float32,
    child_node=torch.int32, node_parent=torch.int32, node_slot=torch.int32, node_incomplete=torch.bool,
    node_live=torch.bool, free_rows=torch.int32, node_count=torch.int32, alloc_ptr=torch.int32,
    free_count=torch.int32, root_visit=torch.int32, root_flag=torch.int32, root_ply=torch.int32,
    root_value=torch.float32, root_std=torch.float32, overflow=torch.int32,
)
_NODE_ARRAYS = ("node_parent", "node_slot", "node_incomplete", "node_live", "free_rows")


def _check_tree(tree) -> tuple:
    """(b, m, c) of a CUDA tree whose arrays the kernels can take."""
    b, m, c = tree.child_visit.shape
    dev = tree.child_visit.device
    if dev.type != "cuda":
        raise ValueError(f"tree kernels: the tree is on {dev}; the CPU runs the batched loops")
    if not 0 < c <= MAX_CHILDREN:
        raise ValueError(f"tree kernels: need 0 < C <= {MAX_CHILDREN}, got C={c}")

    def shape(name):
        return (b, m, c) if name.startswith("child_") else (b, m) if name in _NODE_ARRAYS else (b,)

    _check_fields("tree kernels", [(name, getattr(tree, name), dtype, shape(name))
                                   for name, dtype in _TREE_DTYPES.items()], dev)
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


def _state_fields(what: str, states: TakState, lead: tuple, s: int) -> list:
    """The checks of Tak states with leading dims ``lead`` over ``s`` squares."""
    return [(f"{what}.{name}", x, dtype, (*lead, *shape))
            for name, x, dtype, shape in zip(states._fields, states, _STATE_DTYPES, _state_shapes(s))]


def _check_fields(what: str, checks, dev) -> None:
    """Raise unless each (name, tensor, dtype, shape) of ``checks`` is a
    contiguous tensor of that dtype and shape on ``dev``."""
    for name, x, dtype, shape in checks:
        if x.dtype != dtype or x.device != dev or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype}{list(shape)} on {dev}, "
                             f"got {x.dtype}{list(x.shape)} on {x.device}")


def _launch_table(name: str, symbol: str, tensors, dev, *ints) -> None:
    """Launch ``symbol`` of kernel library ``name`` with the addresses of
    ``tensors`` in one table (the order of the source's struct of
    pointers), then ``ints``, on ``dev``'s current stream."""
    pointers = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    with torch.cuda.device(dev):
        _build.launch(name, symbol, pointers, *ints, torch.cuda.current_stream().cuda_stream)


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
    checks = _state_fields("node_env", env, (b, m), s)
    checks += [(name, loop[name], dtype, (b, max_depth) if name.startswith("path_") else (b,))
               for name, dtype in _SETTLE_LOOP.items()]
    _check_fields("tree_settle", checks, dev)
    out = {name: torch.empty((b,), dtype=dtype, device=dev) for name, dtype in _SETTLE_OUT.items()}
    env_eval = TakState(*(torch.empty((b, *shape), dtype=dtype, device=dev)
                          for shape, dtype in zip(_state_shapes(s), _STATE_DTYPES)))
    tensors = ([getattr(tree, name) for name in _SETTLE_TREE] + list(env) + [loop[name] for name in _SETTLE_LOOP]
               + list(out.values()) + list(env_eval))
    if b:
        _launch_table("settle", "tree_settle_launch", tensors, dev, b, m, c, n, max_depth, eng.half_komi,
                      eng.reversible_limit)
    return dict(
        path_node=loop["path_node"], path_slot=loop["path_slot"], length=out["length"],
        stop_known=out["stop_known"], known_f=out["known_f"], known_p=out["known_p"], known_v=out["known_v"],
        lane_eval_leaf=out["lane_eval_leaf"], lane_eval_root=out["lane_eval_root"],
        lane_root_expand=loop["lane_root_expand"], leaf_parent=loop["leaf_parent"], leaf_slot=loop["leaf_slot"],
        env_eval=env_eval,
    )


def _last_pow2(x: int) -> int:
    return 1 << max(x.bit_length() - 1, 0)


def reduce_layout(rows: int, c: int) -> tuple[int, bool]:
    """(block width, vectorised loads) of torch's CUDA sum over the last
    dimension of a contiguous float32 [rows, c] (ATen's ``Reduce.cuh``
    ``setReduceConfig``, 512 threads a block): a row is summed by one row
    of ``width`` threads, which load 4 consecutive terms at a time where
    ``c >= 128``.  The store kernel sums its priors in that order, which
    ``search/lanewise.py`` ``softmax_sum`` states.  Raises on a layout that
    splits a row across warps, which neither takes (none for ``c <= 1024``)."""
    vectorised = c >= 128
    dim0 = c // 4 if vectorised else c
    d0 = _last_pow2(dim0) if dim0 < 512 else 512
    d1 = _last_pow2(rows) if rows < 512 else 512
    width = min(d0, 32)
    height = min(d1, 512 // width)
    width = min(d0, 512 // height)
    if -(-c // width) >= min(height * 16, 256):
        raise ValueError(f"torch splits a row of {c} terms across warps at {rows} rows")
    return width, vectorised


MASK_CHUNK = 2048  # actions a block of the mask kernel (csrc/expand.cu kMaskChunk)

# The tensors of an expansion's stores, in ``csrc/expand.cu``'s ``Store``
# order: the tree's, the node pool's states', settle's outputs' (the
# evaluated states after them) and the last five, kernel A's children, the
# mask's counts and the evaluation.
_STORE_TREE = ("child_action", "child_logit", "child_prob", "child_visit", "child_flag", "child_ply",
               "child_value", "child_std", "child_node", "node_parent", "node_slot", "node_incomplete",
               "node_live", "free_rows", "node_count", "alloc_ptr", "free_count", "root_visit", "root_value",
               "root_std", "overflow")
_STORE_REC = dict(lane_eval_leaf=torch.bool, lane_eval_root=torch.bool, lane_root_expand=torch.bool,
                  leaf_parent=torch.int64, leaf_slot=torch.int64)


def expand_mask(env_eval: TakState, logits: torch.Tensor, eng) -> tuple:
    """The first half of ``search/core.py`` ``apply_eval`` for a Tak engine
    ``eng``: the legal mask of each lane's evaluated state and kernel A's
    input, ``where(legal, logits.float(), -3e38)`` f32[B, A], with each
    lane's legal actions counted a chunk of :data:`MASK_CHUNK` actions
    (i32[B, chunks], for :func:`expand_store`).  ``logits`` [B, A] in float32
    or bfloat16 with unit stride along a row and any stride between rows."""
    dev = env_eval.tops.device
    b, s = env_eval.tops.shape
    n, a = math.isqrt(s), eng.num_actions
    if dev.type != "cuda" or n * n != s or not 3 <= n <= 8 or n != eng.n:
        raise ValueError(f"expand_mask: needs CUDA states of an engine's n x n board with 3 <= n <= 8, got {s} "
                         f"squares for n={eng.n} on {dev}")
    _check_fields("expand_mask", _state_fields("env_eval", env_eval, (b,), s), dev)
    if (logits.dtype not in (torch.float32, torch.bfloat16) or logits.device != dev
            or tuple(logits.shape) != (b, a) or logits.stride(-1) != 1):
        raise ValueError(f"expand_mask: logits must be float32 or bfloat16 [{b}, {a}] rows of unit stride on "
                         f"{dev}, got {logits.dtype}{list(logits.shape)} strides {logits.stride()} on "
                         f"{logits.device}")
    chunks = -(-a // MASK_CHUNK)
    masked = torch.empty((b, a), dtype=torch.float32, device=dev)
    legal = torch.empty((b, chunks), dtype=torch.int32, device=dev)
    if b:
        _launch_table("expand", "expand_mask_launch", list(env_eval[:6]) + [logits, masked, legal], dev,
                      b, n, a, chunks, logits.stride(0), int(logits.dtype == torch.bfloat16))
    return masked, legal


def expand_store(tree, rec: dict, top_vals: torch.Tensor, top_idx: torch.Tensor, legal: torch.Tensor,
                 v_net: torch.Tensor, var_net: torch.Tensor) -> None:
    """The second half of ``search/core.py`` ``apply_eval``, in place: the
    leaf's and the root's statistics and the guarded expansion of every
    lane, from kernel A's children of :func:`expand_mask`'s logits
    (``top_vals`` f32[B, C], ``top_idx`` [B, C]) and its counts ``legal``;
    ``rec`` is ``settle``'s."""
    b, m, c = _check_tree(tree)
    dev = tree.child_visit.device
    s = tree.node_env.height.shape[-1]
    checks = _state_fields("node_env", tree.node_env, (b, m), s) + _state_fields("env_eval", rec["env_eval"], (b,), s)
    checks += [(name, rec[name], dtype, (b,)) for name, dtype in _STORE_REC.items()]
    checks += [("top_vals", top_vals, torch.float32, (b, c)), ("top_idx", top_idx, torch.int32, (b, c)),
               ("legal", legal, torch.int32, (b, legal.shape[-1]))]
    _check_fields("expand_store", checks, dev)
    nets = [_lane_tensor(x, torch.float32, b, dev) for x in (v_net, var_net)]
    width, vectorised = reduce_layout(b, c)
    tensors = ([getattr(tree, name) for name in _STORE_TREE] + list(tree.node_env) + [rec[k] for k in _STORE_REC]
               + list(rec["env_eval"]) + [top_vals, top_idx, legal] + nets)
    if b:
        _launch_table("expand", "expand_store_launch", tensors, dev, b, m, c, s, legal.shape[-1], width,
                      int(vectorised))
