"""Array-of-trees storage for batched MCTS.

Counterpart of ``takzero_tpu/search/tree.py`` with the same field names,
shapes and meaning: an expanded-node pool ``[B, M]`` (node 0 the root, the
last row a write-sink *scratch* node whose content is garbage by design),
child slots ``[B, M, C]``, a free list for tree reuse, and root statistics
``[B]``.

The port updates trees **in place**: ``reset_lanes`` and the search
kernels write into the tensors they are given (JAX returns new arrays).
Callers that need the old tree clone its tensors first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..tak.state import TakState


class Tree(NamedTuple):
    # Expanded-node pool [B, M]
    node_parent: torch.Tensor
    node_slot: torch.Tensor
    node_incomplete: torch.Tensor  # bool: children truncated to C
    node_env: TakState  # fields lead with [B, M]
    node_count: torch.Tensor  # [B]
    # Child slots [B, M, C]
    child_action: torch.Tensor  # -1 = unused slot
    child_logit: torch.Tensor
    child_prob: torch.Tensor
    child_visit: torch.Tensor
    child_flag: torch.Tensor  # eval triple of the child node (child's POV)
    child_ply: torch.Tensor
    child_value: torch.Tensor
    child_std: torch.Tensor
    child_node: torch.Tensor  # expanded-node index, -1 = unexpanded
    # Allocation state
    node_live: torch.Tensor  # [B, M] bool
    free_rows: torch.Tensor  # [B, M] int32
    alloc_ptr: torch.Tensor  # [B] int32
    free_count: torch.Tensor  # [B] int32
    # Root statistics [B]
    root_visit: torch.Tensor
    root_flag: torch.Tensor
    root_ply: torch.Tensor
    root_value: torch.Tensor
    root_std: torch.Tensor
    # Diagnostics [B]
    overflow: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.child_visit.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.child_visit.shape[1] - 1

    @property
    def max_children(self) -> int:
        return self.child_visit.shape[2]

    def root_expanded(self) -> torch.Tensor:
        """Any valid root slot marks expansion (slot order is ascending
        action, so slot 0 may be a -1 filler on an expanded root)."""
        return self.child_action[:, 0, :].max(dim=1).values >= 0


def _fresh(root_envs: TakState, max_nodes: int, max_children: int):
    """Field -> (value of a fresh tree, broadcastable to the field's shape)."""
    b = root_envs.ply.shape[0]
    m, c = max_nodes + 1, max_children  # +1: write-sink scratch row
    dev = root_envs.ply.device
    i32 = dict(dtype=torch.int32, device=dev)
    ar = torch.arange(m, **i32)
    return dict(
        node_parent=-1,
        node_slot=-1,
        node_incomplete=False,
        node_env=root_envs.map(lambda x: x[:, None]),
        node_count=1,  # node 0 reserved for the root
        child_action=-1,
        child_logit=0.0,
        child_prob=0.0,
        child_visit=0,
        child_flag=0,
        child_ply=0,
        child_value=0.0,
        child_std=0.0,
        child_node=-1,
        node_live=(ar == 0)[None, :],
        free_rows=(ar + 1).clamp(max=m - 1)[None, :],
        alloc_ptr=0,
        free_count=m - 2,
        root_visit=0,
        root_flag=0,
        root_ply=0,
        root_value=0.0,
        root_std=0.0,
        overflow=0,
    ), (b, m, c)


def init_tree(eng, root_envs: TakState, max_nodes: int, max_children: int) -> Tree:
    """Fresh trees for a batch of root environments, on their device."""
    del eng
    fresh, (b, m, c) = _fresh(root_envs, max_nodes, max_children)
    dev = root_envs.ply.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    shapes = dict(
        node_parent=((b, m), i32), node_slot=((b, m), i32),
        node_incomplete=((b, m), dict(dtype=torch.bool, device=dev)),
        node_count=((b,), i32),
        child_action=((b, m, c), i32), child_logit=((b, m, c), f32),
        child_prob=((b, m, c), f32), child_visit=((b, m, c), i32),
        child_flag=((b, m, c), i32), child_ply=((b, m, c), i32),
        child_value=((b, m, c), f32), child_std=((b, m, c), f32),
        child_node=((b, m, c), i32),
        alloc_ptr=((b,), i32), free_count=((b,), i32),
        root_visit=((b,), i32), root_flag=((b,), i32), root_ply=((b,), i32),
        root_value=((b,), f32), root_std=((b,), f32), overflow=((b,), i32),
    )
    out = {}
    for name, val in fresh.items():
        if name == "node_env":
            out[name] = root_envs.map(
                lambda x: x[:, None].expand((b, m) + x.shape[1:]).clone()
            )
        elif name in shapes:
            shape, kw = shapes[name]
            out[name] = torch.full(shape, val, **kw)
        else:  # node_live, free_rows
            out[name] = val.expand(b, m).clone()
    return Tree(**out)


def truncation_stats(tree: Tree) -> torch.Tensor:
    """[B, 2] int32: (expanded nodes, incomplete nodes) over live rows."""
    live = tree.node_live
    expanded = live.sum(dim=1, dtype=torch.int32)
    incomplete = (live & tree.node_incomplete).sum(dim=1, dtype=torch.int32)
    return torch.stack([expanded, incomplete], dim=1)


def _where_(arr: torch.Tensor, mask: torch.Tensor, val) -> None:
    """In place: ``arr[b] = val`` where ``mask[b]`` (val broadcasts)."""
    m = mask.reshape((-1,) + (1,) * (arr.dim() - 1))
    arr.copy_(torch.where(m, val, arr))


def reset_lanes(tree: Tree, mask: torch.Tensor, new_envs: TakState) -> Tree:
    """Reset (in place) the trees where ``mask`` is set, installing
    ``new_envs`` as their roots; returns ``tree``."""
    fresh, _ = _fresh(new_envs, tree.max_nodes, tree.max_children)
    for name, val in fresh.items():
        if name == "node_env":
            for arr, v in zip(tree.node_env, val):
                _where_(arr, mask, v)
        else:
            _where_(getattr(tree, name), mask, val)
    return tree


def descend_host(tree: Tree, action: int) -> Tree | None:
    """Re-root a single tree (B=1) at the root child playing ``action``, on
    the host.

    The port of JAX's ``descend_host``: a breadth-first walk over the child
    links from the new root renumbers the subtree into rows ``0..k-1``
    (the other rows keep their fill values) and the tree comes back on the
    input's device.  Returns ``None`` when the action is not a root child or
    that child was never expanded (the caller rebuilds from the stepped
    position).
    """
    if tree.batch_size != 1:
        raise ValueError("descend_host reuses single-game trees (B=1)")
    dev = tree.child_action.device
    ca = tree.child_action[0].cpu().numpy()
    cn = tree.child_node[0].cpu().numpy()
    slots = np.nonzero(ca[0] == action)[0]
    if len(slots) == 0:
        return None
    slot = int(slots[0])
    r = int(cn[0, slot])
    if r < 0:
        return None

    order = [r]
    seen = {r}
    for node in order:
        for child in cn[node]:
            child = int(child)
            if child >= 0 and child not in seen:
                seen.add(child)
                order.append(child)
    m = cn.shape[0]
    remap = np.full(m, -1, np.int64)
    remap[order] = np.arange(len(order))
    k = len(order)
    take = np.asarray(order)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a[None]).to(dev)

    def copy_pool(arr: torch.Tensor, fill) -> torch.Tensor:
        a = arr[0].cpu().numpy()
        out = np.full_like(a, fill)
        out[:k] = a[take]
        return on_dev(out)

    def copy_env(x: torch.Tensor) -> torch.Tensor:
        a = x[0].cpu().numpy()
        out = a.copy()
        out[:k] = a[take]
        return on_dev(out)

    def relink(links: np.ndarray) -> np.ndarray:
        return np.where(links >= 0, remap[links.clip(0)], -1).astype(np.int32)

    child_node = np.full_like(cn, -1)
    child_node[:k] = relink(cn[take])
    node_parent = np.full(m, -1, np.int32)
    node_parent[:k] = relink(tree.node_parent[0].cpu().numpy()[take])
    node_parent[0] = -1
    node_slot = copy_pool(tree.node_slot, -1)
    node_slot[0, 0] = -1
    idx = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    one = dict(dtype=torch.int32, device=dev)
    return Tree(
        node_parent=on_dev(node_parent),
        node_slot=node_slot,
        node_incomplete=copy_pool(tree.node_incomplete, False),
        node_env=tree.node_env.map(copy_env),
        node_count=torch.tensor([k], **one),
        child_action=copy_pool(tree.child_action, -1),
        child_logit=copy_pool(tree.child_logit, 0.0),
        child_prob=copy_pool(tree.child_prob, 0.0),
        child_visit=copy_pool(tree.child_visit, 0),
        child_flag=copy_pool(tree.child_flag, 0),
        child_ply=copy_pool(tree.child_ply, 0),
        child_value=copy_pool(tree.child_value, 0.0),
        child_std=copy_pool(tree.child_std, 0.0),
        child_node=on_dev(child_node),
        node_live=idx < k,
        free_rows=(idx + k).clamp(max=m - 1),
        alloc_ptr=torch.zeros((1,), **one),
        free_count=torch.tensor([m - 1 - k], **one),
        root_visit=tree.child_visit[:, 0, slot].clone(),
        root_flag=tree.child_flag[:, 0, slot].clone(),
        root_ply=tree.child_ply[:, 0, slot].clone(),
        root_value=tree.child_value[:, 0, slot].clone(),
        root_std=tree.child_std[:, 0, slot].clone(),
        overflow=torch.zeros((1,), **one),
    )


def descend_device(tree: Tree, action) -> tuple[Tree, torch.Tensor]:
    """Single-tree re-root at the root child playing ``action``, on the
    device: the serve path's tree reuse across TEI ``position`` commands.

    The port of JAX's ``descend_device``, an action-keyed wrapper over
    :func:`descend_batch` at B=1.  Returns ``(tree2, ok)`` with ``ok`` a
    0-d bool tensor; when it is False (the action is not a root child, or
    that child was never expanded) ``tree2`` must be discarded.
    """
    if tree.batch_size != 1:
        raise ValueError("descend_device reuses single-game trees (B=1)")
    hit = tree.child_action[0, 0] == torch.as_tensor(action, device=tree.child_action.device)
    slot = hit.to(torch.uint8).argmax()
    tree2, ok = descend_batch(tree, slot[None])
    return tree2, ok[0] & hit.any()


def descend_batch(tree: Tree, slot, min_headroom: int = 0, max_chain: int | None = None):
    """Batched re-root: every lane descends to its root child ``slot``.

    The port of JAX's ``descend_batch`` (same algorithm: reachability by
    parent-pointer doubling, the new root's row swapped into row 0, dead
    rows parked and enumerated into the free list).  Returns a NEW tree
    (the input is left as it was) and ``ok[B]``; lanes where ``ok`` is
    False hold garbage and must be reset by the caller.
    """
    b, m, c = tree.child_action.shape
    dev = tree.child_action.device
    scratch = m - 1
    bar = torch.arange(b, device=dev)
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    slot = slot.to(torch.int64).clamp(0, c - 1)
    r = tree.child_node[bar, 0, slot]
    ok = r >= 0
    rc = r.clamp(min=0).to(torch.int64)

    reach = idx[None, :] == rc[:, None]
    anc = torch.where(tree.node_parent >= 0, tree.node_parent, scratch).to(torch.int64)
    chain = m - 1 if max_chain is None else min(max_chain + 1, m - 1)
    for _ in range(max(1, chain.bit_length())):
        reach = reach | reach.gather(1, anc)
        anc = anc.gather(1, anc)

    k = reach.sum(dim=1, dtype=torch.int32)
    ok = ok & (k + min_headroom <= m - 1)

    root_stats = dict(
        root_visit=tree.child_visit[bar, 0, slot],
        root_flag=tree.child_flag[bar, 0, slot],
        root_ply=tree.child_ply[bar, 0, slot],
        root_value=tree.child_value[bar, 0, slot],
        root_std=tree.child_std[bar, 0, slot],
    )

    def swap0(arr):
        out = arr.clone()
        out[:, 0] = arr[bar, rc]
        return out

    cn_r = tree.child_node[bar, rc]  # [B, C]
    tgt = torch.where(cn_r >= 0, cn_r, scratch).to(torch.int64)
    node_parent = tree.node_parent.clone()
    node_parent[bar[:, None].expand_as(tgt), tgt] = 0
    node_parent[:, 0] = -1

    live = (reach & (idx[None, :] != rc[:, None])) | (idx[None, :] == 0)
    node_parent = torch.where(live, node_parent, -1)
    node_parent[:, scratch] = -1
    dead = ~live & (idx[None, :] != scratch)
    free_count = dead.sum(dim=1, dtype=torch.int32)
    free_rows = torch.argsort(
        torch.where(dead, idx[None, :], m + idx[None, :]), dim=1, stable=True
    ).to(torch.int32)

    node_slot = swap0(tree.node_slot)
    node_slot[:, 0] = -1
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    return Tree(
        node_parent=node_parent,
        node_slot=node_slot,
        node_incomplete=swap0(tree.node_incomplete),
        node_env=tree.node_env.map(swap0),
        node_count=k.clamp(min=1),
        child_action=swap0(tree.child_action),
        child_logit=swap0(tree.child_logit),
        child_prob=swap0(tree.child_prob),
        child_visit=swap0(tree.child_visit),
        child_flag=swap0(tree.child_flag),
        child_ply=swap0(tree.child_ply),
        child_value=swap0(tree.child_value),
        child_std=swap0(tree.child_std),
        child_node=swap0(tree.child_node),
        node_live=live,
        free_rows=free_rows,
        alloc_ptr=zeros,
        free_count=free_count,
        overflow=zeros.clone(),
        **root_stats,
    ), ok

