"""Batched MCTS simulation: forward descent, evaluation, expansion, backup.

Counterpart of ``takzero_tpu/search/core.py`` (``forward`` :101,
``apply_eval`` :305, ``backward`` :430, ``simulate`` :588,
``simulate_batch`` :596): one ``simulate`` call runs one simulation on every
tree of the batch, with the same PUCT selection, visit accounting, guarded
expansion through the top-k that :func:`make_topk` chooses (by default
kernel A, :func:`takzero_torch.ops.topk.exact_top_k_unsorted`) and the exact
win/loss/draw solver.  ``simulate_batch`` is the serve path's K
simulations per network call (the reference's ``virtual`` feature,
mcts.rs:268-328): K descents of the same trees, each known stop backed up
at once, ONE evaluator call over the K*B stacked leaves, then K guarded
expansions and leaf backups.

On a CUDA tree the two data-dependent ``while_loop``s of the JAX program,
the descent and the backup, are hand-written kernels that walk each lane's
path with no host read, and with a Tak engine the forward's tail
(``settle``) is a third and ``apply_eval`` two more around the top-k
(``ops/tree.py``, ``csrc/tree.cu``, ``csrc/settle.cu``,
``csrc/expand.cu``; their per-lane algorithm in plain torch is
``search/lanewise.py``).  On the CPU they are
Python loops of batched operators with one host check per level, which
keep JAX's semantics exactly: the descent runs while ``depth < max_depth
and active.any()`` (one ``.any()`` sync per level) and the backup runs
from ``jmax - 1`` down to the root (one ``.item()`` sync per simulation).
Each read is a ``sync`` span, and each phase of a simulation a
``search.*`` span (``utils/profile.py``).

The rest of a simulation has fixed shapes and no host read: the forward
tail (``settle``), the evaluator and ``apply_eval`` (batched operators on
the CPU and for other engines).  So on a CUDA tree a
whole simulation has none, and within one search
(``simulate.search_scope``, which the Gumbel search opens) its phases are
captured into CUDA graphs in the second simulation and replayed in every
later one (``search/graphs.py``).

The per-node arithmetic (the PUCT pick, the children solver, a node's
backed-up eval, the propagated value, the expansion's children and priors)
is held once, in this module's helpers, which the serve chunk
(``search/serve.py``) and the Gumbel root (``search/gumbel.py``) call too;
they broadcast over [B] or [B, K] lanes.

Trees are updated in place.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable

import torch

from ..ops import tree as _tree
from ..ops.topk import exact_top_k_unsorted, exact_top_k_unsorted_grouped, lax_top_k, topk_plain
from ..tak.engine import TakEngine
from ..tak.state import where_state
from ..utils.profile import host_item, span
from . import eval as ev
from .graphs import MIDDLES, SearchGraphs
from .tree import Tree

NEG = -3.0e38


def _at(row: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """row[..., slot[...]] for a [..., C] row."""
    return row.gather(-1, slot[..., None])[..., 0]


def add_path_visits(child_visit: torch.Tensor, path_node: torch.Tensor, path_slot: torch.Tensor) -> None:
    """One visit on every (node, slot) edge of each lane's path, in place:
    ``child_visit`` int32[B, M, C], the path [B, D] with -1 padding.
    Padded entries add 0 to the scratch row (M - 1), so the update is one
    unconditional scatter-add (``tools/scatter_variants.py`` times its
    alternatives)."""
    b, m, _ = child_visit.shape
    live = path_node >= 0
    bar = torch.arange(b, device=child_visit.device)[:, None].expand_as(path_node)
    child_visit.index_put_(
        (bar, torch.where(live, path_node, m - 1).to(torch.int64), path_slot.clamp(min=0).to(torch.int64)),
        live.to(child_visit.dtype),
        accumulate=True,
    )


def select_child(tree: Tree, bar, node, node_visit, node_flag, beta, forced=None) -> tuple:
    """PUCT's choice in each lane's ``node`` (its rows ``tree.child_*[bar,
    node]``, lanes [...]), given the node's visits and flag and the lane's
    ``beta``: the slot (``forced``'s where given) and that edge's child
    node, flag, ply, value and visits.  Proven wins are pruned unless the
    node is a proven loss; a node that holds only proven wins picks among
    them rather than an invalid slot."""
    action, flag, ply, value, prob, std, visit, child = (a[bar, node] for a in (
        tree.child_action, tree.child_flag, tree.child_ply, tree.child_value, tree.child_prob, tree.child_std,
        tree.child_visit, tree.child_node))
    valid = action >= 0
    q = ev.negated_float(flag, ply, value)
    pv = node_visit.float()[..., None]
    c_rate = torch.log((1.0 + pv + 500.0) / 500.0) + 4.0
    u = c_rate * prob * torch.sqrt(pv) / (1.0 + visit)
    score = q + u + beta[..., None] * std
    pruned = (flag == ev.WIN) & (node_flag != ev.LOSS)[..., None]
    unpruned = valid & ~pruned
    pick = torch.where(unpruned.any(-1, keepdim=True), unpruned, valid)
    slot = torch.where(pick, score, NEG).argmax(-1)
    if forced is not None:
        slot = forced.to(torch.int64)
    return slot, tuple(_at(row, slot) for row in (child, flag, ply, value, visit))


def solve_children(flag, ply, value, valid, incomplete) -> tuple:
    """The solver over a node's children, rows [..., C]: whether every
    valid child is known and the node complete (``incomplete`` [...]
    False), and the node's solved eval (flag, ply, value), the negation of
    its least child's."""
    all_known = (~valid | (flag != ev.VALUE)).all(-1) & valid.any(-1)
    mi = ev.argmin_eval(flag, ply, value, valid)
    return all_known & ~incomplete, ev.negate(*ev.take_eval(flag, ply, value, mi))


def backed_up_eval(trigger, solved, own, val_upd, std_upd) -> tuple:
    """A node's eval after a backup: the ``solved`` (flag, ply, value) and
    std 0 where ``trigger``; else its ``own`` (flag, ply, value, std), the
    value and std moved to ``val_upd`` and ``std_upd`` unless its flag is
    known.  Returns (known, flag, ply, value, std)."""
    solved_f, solved_p, solved_v = solved
    sf, sp, sv, ss = own
    new_f = torch.where(trigger, solved_f, sf)
    new_p = torch.where(trigger, solved_p, sp)
    known = new_f != ev.VALUE
    new_v = torch.where(trigger, solved_v, torch.where(known, sv, val_upd))
    new_s = torch.where(trigger, 0.0, torch.where(known, ss, std_upd))
    return known, new_f, new_p, new_v, new_s


def leaf_propagated(stop_known, known_f, known_p, known_v, v_net, var_net) -> tuple:
    """The (flag, ply, value, variance) each lane backs up from where it
    stopped: a known stop's eval, else the network's value and variance,
    discounted."""
    return (torch.where(stop_known, known_f, ev.VALUE),
            torch.where(stop_known, known_p, 0),
            torch.where(stop_known, known_v, ev.DISCOUNT * v_net),
            torch.where(stop_known, 0.0, ev.DISCOUNT**2 * var_net))


def propagated(part, new, negated, prop) -> tuple:
    """The (flag, ply, value, variance) each lane of ``part`` backs up past
    a node whose eval is now ``new`` (:func:`backed_up_eval`'s): the node's
    eval where it is known, else the value it received (``negated``) and
    the variance, discounted; other lanes keep ``prop``."""
    known, new_f, new_p, new_v, new_s = new
    pf, pp, pv, pvar = prop
    out_f = torch.where(known, new_f, ev.VALUE)
    out_p = torch.where(known, new_p, 0)
    out_v = torch.where(known, new_v, negated * ev.DISCOUNT)
    out_var = torch.where(known, new_s * new_s, pvar * ev.DISCOUNT**2)
    return (torch.where(part, out_f, pf), torch.where(part, out_p, pp), torch.where(part, out_v, pv),
            torch.where(part, out_var, pvar))


def expansion_children(logits, legal, c: int, topk_fn: Callable, lanes: tuple) -> tuple:
    """The children an expansion stores: the ``c`` largest legal entries of
    each row of ``logits`` [N, A] (``legal`` [N, A]) by ``topk_fn``, as
    [*lanes, c] (N the product of ``lanes``): (valid, logit, action,
    prior), the priors a softmax over the valid children."""
    masked_logits = torch.where(legal, logits.float(), NEG).contiguous()
    top_vals, top_idx = topk_fn(masked_logits, c)
    top_vals, top_idx = top_vals.reshape(*lanes, c), top_idx.reshape(*lanes, c)
    valid = top_vals > NEG / 2
    mx = torch.where(valid, top_vals, -torch.inf).max(-1, keepdim=True).values
    ex = torch.where(valid, torch.exp(top_vals - mx), 0.0)
    return valid, top_vals, top_idx, ex / ex.sum(-1, keepdim=True).clamp(min=1e-30)


def _kernel_a(x: torch.Tensor, k: int):
    """Kernel A under this module's name, looked up at each call, so that a
    caller may put a recording or counting version in its place
    (``chip_smoke.py``, the tests)."""
    return exact_top_k_unsorted(x, k)


def _tree_kernels(tree: Tree) -> bool:
    """Whether ``tree``'s descent and backup run as the kernels of
    ``ops/tree.py``: on a CUDA tree.  The CPU runs the batched loops.
    Looked up at each call, so that a test may hold the loops on the card."""
    return tree.child_visit.is_cuda


def _settle_kernel(tree: Tree, eng) -> bool:
    """Whether ``settle`` and ``apply_eval`` run as ``ops/tree.py``'s settle
    and expansion kernels: on a tree whose descent and backup are kernels
    (:func:`_tree_kernels`), searched with a :class:`TakEngine`, whose rules
    the kernels hold.  Other engines keep the batched operators on any
    device.  Looked up at each call, so that a test may hold the batched
    ``settle`` and ``apply_eval`` on the card."""
    return _tree_kernels(tree) and isinstance(eng, TakEngine)


def make_topk(impl: str = "auto") -> Callable:
    """Expansion top-k: ``(masked_logits f32[B, A], k) -> (vals, idx i32)``.

    JAX's choices under JAX's names (``takzero_tpu/search/core.py:48``), so
    that one ``TAKZERO_TOPK`` drives both packages.  The search is
    child-slot-permutation-invariant, so any exact k-largest selection
    works:

    * ``pallas``: kernel A (``exact_top_k_unsorted``) on a CUDA tensor,
      its plain version on a CPU tensor; ascending index order;
    * ``lax``: the library top-k with ``lax.top_k``'s contract, sorted
      descending (``ops.topk.lax_top_k``);
    * ``grouped``: JAX's two-stage grouped library top-k, sorted;
    * ``exact_ref``: ``topk_plain`` on any device.

    ``auto`` reads ``TAKZERO_TOPK`` and falls back to ``pallas`` (JAX falls
    back to ``pallas`` on its TPU and to ``lax`` elsewhere).
    """
    if impl == "auto":
        impl = os.environ.get("TAKZERO_TOPK", "") or "pallas"
    impls = {"pallas": _kernel_a, "lax": lax_top_k, "grouped": exact_top_k_unsorted_grouped,
             "exact_ref": topk_plain}
    if impl not in impls:
        raise ValueError(f"unknown top-k impl {impl!r}: expected auto or one of {sorted(impls)}")
    return impls[impl]


def make_kernels(eng: TakEngine, evaluator: Callable, max_depth: int = 48, topk: str = "auto"):
    """Build ``(simulate, simulate_batch)``.

    ``simulate(tree, beta, forced_slot=None, *, skip_root=False)`` and
    ``simulate_batch(tree, beta, k)``; ``with simulate.search_scope(tree) as
    sim`` gives the ``simulate`` of one search's simulations.
    ``evaluator(envs) -> (policy_logits [B, A], value [B], variance [B])``;
    one with a ``capturable`` attribute that is True is captured in a
    search's CUDA graphs (:func:`with_agent`).  Expansion selects
    children with ``make_topk(topk)`` (by default kernel A), once per
    ``apply_eval``; the choice is fixed here, as in JAX.

    As JAX's, the kernels work with any game: ``eng`` needs only batched
    ``step(envs, action)``, ``terminal_kind(envs)`` and
    ``legal_mask(envs)``, and its state is a NamedTuple of tensors with a
    ``ply`` field and a ``map(fn)`` method, as ``tak.state.TakState``
    (``tests/test_torch_reference_checks.py`` runs a SafeCrack engine).
    """
    topk_fn = make_topk(topk)
    capture_evaluator = getattr(evaluator, "capturable", False) is True

    def descend(tree: Tree, beta, forced_slot, skip_root: bool, out: dict | None = None) -> dict:
        """The descent: selection from the root down to the first
        unexpanded child of each lane, or to ``max_depth``; the descent
        kernel on a CUDA tree, else the level loop.  Its outputs
        (:func:`_descent_buffers`' fields) are written in place into
        ``out``, a search's buffers at fixed addresses, or into fresh
        tensors."""
        b, m, c = tree.child_visit.shape
        dev = tree.child_visit.device
        o = _descent_buffers(b, max_depth, dev) if out is None else out
        if _tree_kernels(tree):
            return _tree.tree_descend(tree, beta, forced_slot, skip_root, max_depth, o)
        bar = torch.arange(b, device=dev)

        if not skip_root:
            tree.root_visit.add_(1)

        root_unexp = ~tree.root_expanded()
        torch.bitwise_and(root_unexp, tree.root_flag == 0, out=o["lane_root_expand"])

        cur = o["cur"].zero_()
        cur_flag = o["cur_flag"].copy_(tree.root_flag)
        cur_visit = tree.root_visit.clone()
        active = torch.bitwise_not(root_unexp, out=o["active"])
        path_node = o["path_node"].fill_(-1)
        path_slot = o["path_slot"].fill_(-1)
        length = o["length"].zero_()
        stop_known = o["stop_known"].zero_()
        known_f = o["known_f"].zero_()
        known_p = o["known_p"].zero_()
        known_v = o["known_v"].zero_()
        stop_leaf = o["stop_leaf"].zero_()
        leaf_parent = o["leaf_parent"].zero_()
        leaf_slot = o["leaf_slot"].zero_()

        d = 0
        while d < max_depth and host_item(active.any()):  # one host sync per level
            slot, (cn, cf, cp, cv, cvisit) = select_child(tree, bar, cur, cur_visit, cur_flag, beta,
                                                           forced_slot if d == 0 else None)
            cvisit = cvisit + 1  # this sim's visit
            path_node[:, d] = torch.where(active, cur, -1)
            path_slot[:, d] = torch.where(active, slot, -1)

            unexp = cn < 0
            new_known = active & unexp & (cf != ev.VALUE)
            new_leaf = active & unexp & (cf == ev.VALUE)
            active &= ~unexp  # the lanes that continue

            length.masked_fill_(new_known | new_leaf, d + 1)
            stop_known |= new_known
            torch.where(new_known, cf, known_f, out=known_f)
            torch.where(new_known, cp, known_p, out=known_p)
            torch.where(new_known, cv, known_v, out=known_v)
            stop_leaf |= new_leaf
            torch.where(new_leaf, cur, leaf_parent, out=leaf_parent)
            torch.where(new_leaf, slot, leaf_slot, out=leaf_slot)
            torch.where(active, cn.to(torch.int64), cur, out=cur)
            torch.where(active, cf, cur_flag, out=cur_flag)
            cur_visit = torch.where(active, cvisit, cur_visit)
            d += 1
        return o

    def settle(tree: Tree, loop: dict) -> dict:
        """From the end of the level loop to the evaluation: the depth
        clip, the path's visits, the leaf environments and terminal
        discovery; the settle kernel on a CUDA tree searched with a Tak
        engine (:func:`_settle_kernel`), else batched operators.  Fixed
        shapes and no host read: a search replays it from a CUDA graph
        (``search_scope``)."""
        if _settle_kernel(tree, eng):
            return _tree.tree_settle(tree, loop, eng, max_depth)
        b, m, c = tree.child_visit.shape
        bar = torch.arange(b, device=tree.child_visit.device)
        cur, cur_flag = loop["cur"], loop["cur_flag"]
        path_node, path_slot = loop["path_node"], loop["path_slot"]
        leaf_parent, leaf_slot = loop["leaf_parent"], loop["leaf_slot"]
        stop_leaf, lane_root_expand = loop["stop_leaf"], loop["lane_root_expand"]

        # Depth-clipped lanes back up the current node's own eval: flag,
        # value and ply from its parent edge.
        clipped = loop["active"]
        stop_known = loop["stop_known"] | clipped
        known_f = torch.where(clipped, cur_flag, loop["known_f"])
        clip_parent = tree.node_parent[bar, cur].clamp(min=0).to(torch.int64)
        clip_slot = tree.node_slot[bar, cur].clamp(min=0).to(torch.int64)
        known_p = torch.where(clipped, tree.child_ply[bar, clip_parent, clip_slot], loop["known_p"])
        known_v = torch.where(clipped, tree.child_value[bar, clip_parent, clip_slot], loop["known_v"])
        length = torch.where(clipped, max_depth, loop["length"])
        tree.overflow.add_(clipped.to(torch.int32))

        add_path_visits(tree.child_visit, path_node, path_slot)

        # Leaf environment and terminal discovery.
        parent_env = tree.node_env.map(lambda a: a[bar, leaf_parent])
        leaf_action = tree.child_action[bar, leaf_parent, leaf_slot].clamp(min=0)
        stepped = eng.step(parent_env, leaf_action)
        root_env = tree.node_env.map(lambda a: a[:, 0])
        env_eval = where_state(lane_root_expand, root_env, stepped)
        tk = eng.terminal_kind(env_eval)  # 0 ongoing / 1 win / 2 loss / 3 draw

        leaf_term = stop_leaf & (tk != 0)
        root_term = lane_root_expand & (tk != 0)
        # Terminal leaves become known (tk, ply 0, std 0); other lanes write
        # to the scratch row so the stores are unconditional.
        # (Stored values are device tensors: a Python number would be
        # copied from the host, which a CUDA graph cannot capture.)
        t_node = torch.where(leaf_term, leaf_parent, m - 1)
        tree.child_flag[bar, t_node, leaf_slot] = tk
        tree.child_ply[bar, t_node, leaf_slot] = torch.zeros_like(tk)
        tree.child_std[bar, t_node, leaf_slot] = torch.zeros_like(loop["known_v"])
        tree.root_flag.copy_(torch.where(root_term, tk, tree.root_flag))
        tree.root_ply.copy_(torch.where(root_term, 0, tree.root_ply))
        tree.root_std.copy_(torch.where(root_term, 0.0, tree.root_std))
        stop_known = stop_known | leaf_term
        known_f = torch.where(leaf_term, tk, known_f)
        known_p = torch.where(leaf_term, 0, known_p)
        known_v = torch.where(leaf_term, 0.0, known_v)

        return dict(
            path_node=path_node,
            path_slot=path_slot,
            length=length,
            stop_known=stop_known,
            known_f=known_f,
            known_p=known_p,
            known_v=known_v,
            lane_eval_leaf=stop_leaf & ~leaf_term,
            lane_eval_root=lane_root_expand & ~root_term,
            lane_root_expand=lane_root_expand,
            leaf_parent=leaf_parent,
            leaf_slot=leaf_slot,
            env_eval=env_eval,
        )

    def forward(tree: Tree, beta, forced_slot, skip_root: bool, out: dict | None = None):
        """The descent (into ``out`` or fresh tensors) and its settling: a
        simulation's ``rec``."""
        return settle(tree, descend(tree, beta, forced_slot, skip_root, out))

    def apply_eval(tree: Tree, rec, logits, v_net, var_net):
        """The evaluation's statistics and the guarded expansion of every
        lane's leaf (or root): the two expansion kernels around the top-k
        on a CUDA tree searched with a Tak engine (:func:`_settle_kernel`),
        else batched operators.  Fixed shapes and no host read."""
        b, m, c = tree.child_visit.shape
        if _settle_kernel(tree, eng):
            masked, legal = _tree.expand_mask(rec["env_eval"], logits, eng)
            top_vals, top_idx = topk_fn(masked, c)
            _tree.expand_store(tree, rec, top_vals, top_idx, legal, v_net, var_net)
            return tree
        bar = torch.arange(b, device=tree.child_visit.device)
        leaf_parent, leaf_slot = rec["leaf_parent"], rec["leaf_slot"]
        lane_eval_leaf = rec["lane_eval_leaf"]
        lane_eval_root = rec["lane_eval_root"]
        lane_root_expand = rec["lane_root_expand"]
        env_eval = rec["env_eval"]
        v_net = v_net.float()
        sd_net = torch.sqrt(var_net.float())

        n_leaf = tree.child_visit[bar, leaf_parent, leaf_slot].float().clamp(min=1.0)
        old_v = tree.child_value[bar, leaf_parent, leaf_slot]
        old_s = tree.child_std[bar, leaf_parent, leaf_slot]
        leaf_v_after = old_v + (v_net - old_v) / n_leaf
        leaf_s_after = old_s + (sd_net - old_s) / n_leaf
        ls_node = torch.where(lane_eval_leaf, leaf_parent, m - 1)
        tree.child_value[bar, ls_node, leaf_slot] = leaf_v_after
        tree.child_std[bar, ls_node, leaf_slot] = leaf_s_after
        rn = tree.root_visit.float().clamp(min=1.0)
        root_v_after = tree.root_value + (v_net - tree.root_value) / rn
        root_s_after = tree.root_std + (sd_net - tree.root_std) / rn
        tree.root_value.copy_(torch.where(lane_eval_root, root_v_after, tree.root_value))
        tree.root_std.copy_(torch.where(lane_eval_root, root_s_after, tree.root_std))
        v_after = torch.where(lane_eval_root, root_v_after, leaf_v_after)
        s_after = torch.where(lane_eval_root, root_s_after, leaf_s_after)

        legal = eng.legal_mask(env_eval)  # [B, A]
        valid_child, top_vals, top_idx, probs = expansion_children(logits, legal, c, topk_fn, (b,))

        # Guarded expansion; non-expanding lanes write to the scratch row.
        capacity = m - 1
        already = (tree.child_node[bar, leaf_parent, leaf_slot] >= 0) & ~lane_root_expand
        alloc_row = tree.free_rows[bar, tree.alloc_ptr.clamp(0, m - 1).to(torch.int64)]
        can_expand = lane_root_expand | (tree.alloc_ptr < tree.free_count)
        evaluated = lane_eval_leaf | lane_eval_root
        expanding = evaluated & can_expand & ~already
        new_node = torch.where(
            expanding, torch.where(lane_root_expand, 0, alloc_row), capacity
        ).to(torch.int64)

        tree.child_action[bar, new_node] = torch.where(valid_child, top_idx, -1).to(torch.int32)
        tree.child_logit[bar, new_node] = torch.where(valid_child, top_vals, 0.0)
        tree.child_prob[bar, new_node] = probs
        zero = tree.child_visit.new_zeros(())  # a device value (see ``settle``)
        tree.child_visit[bar, new_node] = zero
        tree.child_flag[bar, new_node] = zero
        tree.child_ply[bar, new_node] = zero
        tree.child_value[bar, new_node] = -v_after[:, None].expand(b, c)
        tree.child_std[bar, new_node] = s_after[:, None].expand(b, c)
        tree.child_node[bar, new_node] = zero - 1

        leaf_expand = expanding & lane_eval_leaf
        tree.node_parent[bar, new_node] = torch.where(leaf_expand, leaf_parent, -1).to(torch.int32)
        tree.node_slot[bar, new_node] = torch.where(leaf_expand, leaf_slot, -1).to(torch.int32)
        tree.node_incomplete[bar, new_node] = legal.sum(-1) > c
        for pool, val in zip(tree.node_env, env_eval):
            pool[bar, new_node] = val
        link = torch.where(leaf_expand, leaf_parent, capacity)
        tree.child_node[bar, link, leaf_slot] = new_node.to(torch.int32)
        tree.node_count.add_(leaf_expand.to(torch.int32))
        tree.alloc_ptr.add_(leaf_expand.to(torch.int32))
        tree.node_live[bar, new_node] = expanding
        tree.overflow.add_((evaluated & ~can_expand).to(torch.int32))
        return tree

    def backward(tree: Tree, rec, v_net, var_net, skip_root: bool, mode: str = "all"):
        """``mode``: "all" (known stops and evaluated leaves), "known" or
        "leaf".  The backup kernel on a CUDA tree; else the level loop,
        from the deepest level to back up, ``jmax``, read here (one host
        sync)."""
        if _tree_kernels(tree):
            _tree.tree_backup(tree, rec, v_net, var_net, skip_root, mode)
            return tree
        b, m, c = tree.child_visit.shape
        bar = torch.arange(b, device=tree.child_visit.device)
        path_node, path_slot = rec["path_node"], rec["path_slot"]
        length = rec["length"]
        stop_known = rec["stop_known"]
        active_bwd = {
            "all": stop_known | rec["lane_eval_leaf"],
            "known": stop_known,
            "leaf": rec["lane_eval_leaf"],
        }[mode]
        v_net = v_net.float()
        var_net = var_net.float()

        prop = leaf_propagated(stop_known, rec["known_f"], rec["known_p"], rec["known_v"], v_net, var_net)

        min_j = 1 if skip_root else 0
        jmax = host_item(torch.where(active_bwd, length, 0).max())  # one host sync

        for j in range(jmax - 1, min_j - 1, -1):
            part = active_bwd & (j < length)
            is_root = j == 0
            node_j = path_node[:, j].clamp(min=0).to(torch.int64)
            if is_root:
                pn = torch.zeros_like(node_j)
                ps = torch.zeros_like(node_j)
            else:
                pn = path_node[:, j - 1].clamp(min=0).to(torch.int64)
                ps = path_slot[:, j - 1].clamp(min=0).to(torch.int64)

            p_flag = tree.child_flag[bar, pn]
            p_ply = tree.child_ply[bar, pn]
            p_value = tree.child_value[bar, pn]
            p_std = tree.child_std[bar, pn]
            if is_root:
                sf, sp, sv, ss = tree.root_flag, tree.root_ply, tree.root_value, tree.root_std
                svisit = tree.root_visit
            else:
                sf, sp, sv, ss = (_at(r, ps) for r in (p_flag, p_ply, p_value, p_std))
                svisit = _at(tree.child_visit[bar, pn], ps)

            # The solver over this node's children.
            pf, pp, pv, pvar = prop
            closed, solved = solve_children(tree.child_flag[bar, node_j], tree.child_ply[bar, node_j],
                                            tree.child_value[bar, node_j], tree.child_action[bar, node_j] >= 0,
                                            tree.node_incomplete[bar, node_j])
            trigger = (pf == ev.LOSS) | closed

            negated = ev.negated_float(pf, pp, pv)
            visf = svisit.float().clamp(min=1.0)
            val_upd = sv + (negated - sv) / visf
            std_upd = ss + (torch.sqrt(pvar) - ss) / visf
            new = backed_up_eval(trigger, solved, (sf, sp, sv, ss), val_upd, std_upd)
            _, new_f, new_p, new_v, new_s = new

            if is_root:
                tree.root_flag.copy_(torch.where(part, new_f, tree.root_flag))
                tree.root_ply.copy_(torch.where(part, new_p, tree.root_ply))
                tree.root_value.copy_(torch.where(part, new_v, tree.root_value))
                tree.root_std.copy_(torch.where(part, new_s, tree.root_std))
            else:
                # Blend the updated slot into the gathered parent row and
                # write the row back.
                sel = part[:, None] & (ps[:, None] == torch.arange(c, device=ps.device))
                tree.child_flag[bar, pn] = torch.where(sel, new_f[:, None], p_flag)
                tree.child_ply[bar, pn] = torch.where(sel, new_p[:, None], p_ply)
                tree.child_value[bar, pn] = torch.where(sel, new_v[:, None], p_value)
                tree.child_std[bar, pn] = torch.where(sel, new_s[:, None], p_std)

            prop = propagated(part, new, negated, prop)
        return tree

    def simulate(tree: Tree, beta, forced_slot=None, *, skip_root: bool = False, graphs=None):
        if graphs is None:
            run, loop, beta = _eager, None, _betas(tree, beta)
        else:
            graphs.check(tree, skip_root, forced_slot is None)
            run, loop = graphs.run, graphs.loop
            beta, forced_slot = graphs.inputs(beta, forced_slot)
        with span("search.forward"):
            rec = run("forward", lambda: forward(tree, beta, forced_slot, skip_root, loop))
        with span("search.evaluate"):
            logits, v_net, var_net = run("evaluate", lambda: evaluator(rec["env_eval"]))
        with span("search.apply_eval"):
            run("apply_eval", lambda: apply_eval(tree, rec, logits, v_net, var_net))
        with span("search.backward"):
            run("backward", lambda: backward(tree, rec, v_net, var_net, skip_root))
        MIDDLES["eager" if graphs is None else graphs.end_simulation()] += 1
        return tree

    @contextlib.contextmanager
    def search_scope(tree: Tree):
        """``simulate`` for the simulations of one search of ``tree``.

        On a CUDA device their phases (the descent kernel and ``settle``,
        the evaluator, ``apply_eval``, the backup kernel) run from CUDA
        graphs (``graphs.SearchGraphs``), which read ``tree``'s storage and
        this evaluator's state as they are during the search and are
        released when the scope closes.  Elsewhere it is ``simulate``
        itself."""
        if not _tree_kernels(tree):
            yield simulate
            return
        graphs = SearchGraphs(tree, _descent_buffers(tree.batch_size, max_depth, tree.child_visit.device),
                              capture_evaluator)
        try:
            yield functools.partial(simulate, graphs=graphs)
        finally:
            graphs.close()

    def simulate_batch(tree: Tree, beta, k: int):
        """K simulations per tree with ONE evaluator call (mcts.rs:268-328).

        Precondition: every root expanded (run one plain ``simulate`` on a
        fresh tree first).  Root statistics update as in ``simulate``.
        """
        b = tree.batch_size
        beta = _betas(tree, beta)
        zero = torch.zeros((b,), dtype=torch.float32, device=tree.child_visit.device)
        recs = []
        for _ in range(k):
            with span("search.forward"):
                rec = forward(tree, beta, None, False)
            # Known stops (terminals, solved subtrees, depth clips) are
            # backed up at once, as the reference does.
            with span("search.backward"):
                backward(tree, rec, zero, zero, False, mode="known")
            recs.append(rec)

        # One evaluator call over all K*B leaves, stacked k-major as JAX's
        # scan stacks them.
        with span("search.evaluate"):
            envs = type(recs[0]["env_eval"])(*(torch.cat(parts) for parts in zip(*(r["env_eval"] for r in recs))))
            logits, v_net, var_net = evaluator(envs)
        logits = logits.reshape(k, b, -1)
        v_net = v_net.float().reshape(k, b)
        var_net = var_net.float().reshape(k, b)
        for i, rec in enumerate(recs):
            with span("search.apply_eval"):
                apply_eval(tree, rec, logits[i], v_net[i], var_net[i])
            with span("search.backward"):
                backward(tree, rec, v_net[i], var_net[i], False, mode="leaf")
        return tree

    # The phases of one simulation, for the tools that time them
    # (``tools/phase_cliff.py``), as JAX's ``simulate.phases``.
    simulate.phases = dict(forward=forward, apply_eval=apply_eval, backward=backward, descend=descend,
                           settle=settle)
    simulate.search_scope = search_scope
    return simulate, simulate_batch


def with_agent(evaluate: Callable, agent) -> Callable:
    """``envs -> evaluate(agent, envs)``: a search's evaluator bound to an
    agent, capturable in CUDA graphs where ``evaluate`` declares itself so
    (a ``capturable`` attribute that is True:
    :func:`takzero_torch.models.agent.make_net_evaluate`'s evaluator of one
    process).  An evaluator that declares nothing runs eagerly in every
    simulation, between a search's graphs."""

    def evaluator(envs):
        return evaluate(agent, envs)

    evaluator.capturable = getattr(evaluate, "capturable", False) is True
    return evaluator


def _descent_buffers(b: int, max_depth: int, device) -> dict:
    """Uninitialised outputs of the descent's level loop over ``b`` lanes:
    the lanes that expand their root, the current node, flag and activity
    (``active`` after the loop: the depth-clipped lanes), the path, its
    length, the known stops and their evals, the leaves and their edges."""
    i32 = dict(dtype=torch.int32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    flag = dict(dtype=torch.bool, device=device)
    return dict(
        lane_root_expand=torch.empty((b,), **flag),
        cur=torch.empty((b,), **i64),
        cur_flag=torch.empty((b,), **i32),
        active=torch.empty((b,), **flag),
        path_node=torch.empty((b, max_depth), **i32),
        path_slot=torch.empty((b, max_depth), **i32),
        length=torch.empty((b,), **i32),
        stop_known=torch.empty((b,), **flag),
        known_f=torch.empty((b,), **i32),
        known_p=torch.empty((b,), **i32),
        known_v=torch.empty((b,), dtype=torch.float32, device=device),
        stop_leaf=torch.empty((b,), **flag),
        leaf_parent=torch.empty((b,), **i64),
        leaf_slot=torch.empty((b,), **i64),
    )


def _eager(phase: str, fn: Callable):
    del phase
    return fn()


def _betas(tree: Tree, beta) -> torch.Tensor:
    """``beta`` as f32[B] on the tree's device (a scalar becomes a fill, not
    a host-to-device copy)."""
    b, dev = tree.batch_size, tree.child_visit.device
    if isinstance(beta, torch.Tensor):
        return beta.to(device=dev, dtype=torch.float32).expand(b)
    return torch.full((b,), float(beta), dtype=torch.float32, device=dev)


def make_simulate(eng: TakEngine, evaluator: Callable, max_depth: int = 48, topk: str = "auto"):
    """Build ``simulate(tree, beta, forced_slot, skip_root) -> Tree``."""
    return make_kernels(eng, evaluator, max_depth, topk)[0]


def make_simulate_batch(eng: TakEngine, evaluator: Callable, max_depth: int = 48, topk: str = "auto"):
    """Build ``simulate_batch(tree, beta, k) -> Tree`` (the serve-path kernel)."""
    return make_kernels(eng, evaluator, max_depth, topk)[1]
