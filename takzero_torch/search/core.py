"""Batched MCTS simulation: forward descent, evaluation, expansion, backup.

Counterpart of ``takzero_tpu/search/core.py`` (``forward`` :101,
``apply_eval`` :305, ``backward`` :430, ``simulate`` :588): one
``simulate`` call runs one simulation on every tree of the batch, with the
same PUCT selection, visit accounting, guarded expansion through the exact
unsorted top-k (kernel A, :func:`takzero_torch.ops.topk.exact_top_k_unsorted`)
and the exact win/loss/draw solver.

The two data-dependent ``while_loop``s of the JAX program become Python
loops with one host check per level, which keeps JAX's semantics exactly:
the descent runs while ``depth < max_depth and active.any()`` (one
``.any()`` sync per level) and the backup runs from ``jmax - 1`` down to
the root (one ``.item()`` sync per simulation).

Trees are updated in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.topk import exact_top_k_unsorted
from ..tak.engine import TakEngine
from ..tak.state import where_state
from . import eval as ev
from .tree import Tree

NEG = -3.0e38


def _at(row: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """row[b, slot[b]] for a [B, C] row."""
    return row.gather(1, slot[:, None])[:, 0]


def make_kernels(eng: TakEngine, evaluator: Callable, max_depth: int = 48):
    """Build ``simulate(tree, beta, forced_slot=None, *, skip_root=False)``.

    ``evaluator(envs) -> (policy_logits [B, A], value [B], variance [B])``.
    Expansion selects children with kernel A (``exact_top_k_unsorted``).
    """

    def forward(tree: Tree, beta, forced_slot, skip_root: bool):
        b, m, c = tree.child_visit.shape
        dev = tree.child_visit.device
        bar = torch.arange(b, device=dev)

        if not skip_root:
            tree.root_visit.add_(1)

        root_unexp = ~tree.root_expanded()
        lane_root_expand = root_unexp & (tree.root_flag == 0)

        i32 = dict(dtype=torch.int32, device=dev)
        cur = torch.zeros((b,), dtype=torch.int64, device=dev)
        cur_flag = tree.root_flag.clone()
        cur_visit = tree.root_visit.clone()
        active = ~root_unexp
        path_node = torch.full((b, max_depth), -1, **i32)
        path_slot = torch.full((b, max_depth), -1, **i32)
        length = torch.zeros((b,), **i32)
        stop_known = torch.zeros((b,), dtype=torch.bool, device=dev)
        known_f = torch.zeros((b,), **i32)
        known_p = torch.zeros((b,), **i32)
        known_v = torch.zeros((b,), dtype=torch.float32, device=dev)
        stop_leaf = torch.zeros_like(stop_known)
        leaf_parent = torch.zeros_like(cur)
        leaf_slot = torch.zeros_like(cur)

        d = 0
        while d < max_depth and bool(active.any()):  # one host sync per level
            row_action = tree.child_action[bar, cur]
            row_flag = tree.child_flag[bar, cur]
            row_ply = tree.child_ply[bar, cur]
            row_value = tree.child_value[bar, cur]
            row_prob = tree.child_prob[bar, cur]
            row_std = tree.child_std[bar, cur]
            row_visit = tree.child_visit[bar, cur]
            row_node = tree.child_node[bar, cur]

            valid = row_action >= 0
            q = ev.negated_float(row_flag, row_ply, row_value)
            pv = cur_visit.float()[:, None]
            c_rate = torch.log((1.0 + pv + 500.0) / 500.0) + 4.0
            u = c_rate * row_prob * torch.sqrt(pv) / (1.0 + row_visit)
            score = q + u + beta[:, None] * row_std
            pruned = (row_flag == ev.WIN) & (cur_flag != ev.LOSS)[:, None]
            unpruned = valid & ~pruned
            # An incomplete node may hold only proven-win children: select
            # among them rather than an invalid slot.
            pick = torch.where(unpruned.any(-1, keepdim=True), unpruned, valid)
            slot = torch.where(pick, score, NEG).argmax(-1)
            if forced_slot is not None and d == 0:
                slot = forced_slot.to(torch.int64)

            path_node[:, d] = torch.where(active, cur, -1)
            path_slot[:, d] = torch.where(active, slot, -1)

            cn = _at(row_node, slot)
            cf = _at(row_flag, slot)
            cp = _at(row_ply, slot)
            cv = _at(row_value, slot)
            cvisit = _at(row_visit, slot) + 1  # this sim's visit

            unexp = cn < 0
            new_known = active & unexp & (cf != ev.VALUE)
            new_leaf = active & unexp & (cf == ev.VALUE)
            cont = active & ~unexp

            length = torch.where(new_known | new_leaf, d + 1, length)
            stop_known = stop_known | new_known
            known_f = torch.where(new_known, cf, known_f)
            known_p = torch.where(new_known, cp, known_p)
            known_v = torch.where(new_known, cv, known_v)
            stop_leaf = stop_leaf | new_leaf
            leaf_parent = torch.where(new_leaf, cur, leaf_parent)
            leaf_slot = torch.where(new_leaf, slot, leaf_slot)
            cur = torch.where(cont, cn.to(torch.int64), cur)
            cur_flag = torch.where(cont, cf, cur_flag)
            cur_visit = torch.where(cont, cvisit, cur_visit)
            active = cont
            d += 1

        # Depth-clipped lanes back up the current node's own eval: flag,
        # value and ply from its parent edge.
        clipped = active
        stop_known = stop_known | clipped
        known_f = torch.where(clipped, cur_flag, known_f)
        clip_parent = tree.node_parent[bar, cur].clamp(min=0).to(torch.int64)
        clip_slot = tree.node_slot[bar, cur].clamp(min=0).to(torch.int64)
        known_p = torch.where(clipped, tree.child_ply[bar, clip_parent, clip_slot], known_p)
        known_v = torch.where(clipped, tree.child_value[bar, clip_parent, clip_slot], known_v)
        length = torch.where(clipped, max_depth, length)
        tree.overflow.add_(clipped.to(torch.int32))

        # Visit increments along the path; padded entries add 0 to the
        # scratch row.
        live_path = path_node >= 0
        tree.child_visit.index_put_(
            (
                bar[:, None].expand(b, max_depth),
                torch.where(live_path, path_node, m - 1).to(torch.int64),
                path_slot.clamp(min=0).to(torch.int64),
            ),
            live_path.to(torch.int32),
            accumulate=True,
        )

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
        t_node = torch.where(leaf_term, leaf_parent, m - 1)
        tree.child_flag[bar, t_node, leaf_slot] = tk
        tree.child_ply[bar, t_node, leaf_slot] = 0
        tree.child_std[bar, t_node, leaf_slot] = 0.0
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

    def apply_eval(tree: Tree, rec, logits, v_net, var_net):
        b, m, c = tree.child_visit.shape
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
        masked_logits = torch.where(legal, logits.float(), NEG).contiguous()
        top_vals, top_idx = exact_top_k_unsorted(masked_logits, c)
        valid_child = top_vals > NEG / 2
        mx = torch.where(valid_child, top_vals, -torch.inf).max(-1, keepdim=True).values
        ex = torch.where(valid_child, torch.exp(top_vals - mx), 0.0)
        probs = ex / ex.sum(-1, keepdim=True).clamp(min=1e-30)

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
        tree.child_visit[bar, new_node] = 0
        tree.child_flag[bar, new_node] = 0
        tree.child_ply[bar, new_node] = 0
        tree.child_value[bar, new_node] = -v_after[:, None].expand(b, c)
        tree.child_std[bar, new_node] = s_after[:, None].expand(b, c)
        tree.child_node[bar, new_node] = -1

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

    def backward(tree: Tree, rec, v_net, var_net, skip_root: bool):
        b, m, c = tree.child_visit.shape
        bar = torch.arange(b, device=tree.child_visit.device)
        path_node, path_slot = rec["path_node"], rec["path_slot"]
        length = rec["length"]
        stop_known = rec["stop_known"]
        active_bwd = stop_known | rec["lane_eval_leaf"]
        v_net = v_net.float()
        var_net = var_net.float()

        pf = torch.where(stop_known, rec["known_f"], ev.VALUE)
        pp = torch.where(stop_known, rec["known_p"], 0)
        pv = torch.where(stop_known, rec["known_v"], ev.DISCOUNT * v_net)
        pvar = torch.where(stop_known, 0.0, ev.DISCOUNT**2 * var_net)

        min_j = 1 if skip_root else 0
        jmax = int(torch.where(active_bwd, length, 0).max())  # one host sync

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

            # Children of this node (solver inputs).
            ca = tree.child_action[bar, node_j]
            cfl = tree.child_flag[bar, node_j]
            cpl = tree.child_ply[bar, node_j]
            cva = tree.child_value[bar, node_j]
            validc = ca >= 0
            all_known = (~validc | (cfl != ev.VALUE)).all(-1) & validc.any(-1)
            incomplete = tree.node_incomplete[bar, node_j]
            trigger = (pf == ev.LOSS) | (all_known & ~incomplete)
            mi = ev.argmin_eval(cfl, cpl, cva, validc)
            solved_f, solved_p, solved_v = ev.negate(*ev.take_eval(cfl, cpl, cva, mi))

            new_f = torch.where(trigger, solved_f, sf)
            new_p = torch.where(trigger, solved_p, sp)
            known_now = new_f != ev.VALUE

            negated = ev.negated_float(pf, pp, pv)
            visf = svisit.float().clamp(min=1.0)
            val_upd = sv + (negated - sv) / visf
            std_upd = ss + (torch.sqrt(pvar) - ss) / visf
            new_v = torch.where(trigger, solved_v, torch.where(known_now, sv, val_upd))
            new_s = torch.where(trigger, 0.0, torch.where(known_now, ss, std_upd))

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

            # Outgoing propagated value.
            out_f = torch.where(known_now, new_f, ev.VALUE)
            out_p = torch.where(known_now, new_p, 0)
            out_v = torch.where(known_now, new_v, negated * ev.DISCOUNT)
            out_var = torch.where(known_now, new_s * new_s, pvar * ev.DISCOUNT**2)
            pf = torch.where(part, out_f, pf)
            pp = torch.where(part, out_p, pp)
            pv = torch.where(part, out_v, pv)
            pvar = torch.where(part, out_var, pvar)
        return tree

    def simulate(tree: Tree, beta, forced_slot=None, *, skip_root: bool = False):
        b = tree.batch_size
        dev = tree.child_visit.device
        if isinstance(beta, torch.Tensor):
            beta = beta.to(device=dev, dtype=torch.float32).expand(b)
        else:  # a fill, not a host-to-device copy
            beta = torch.full((b,), float(beta), dtype=torch.float32, device=dev)
        rec = forward(tree, beta, forced_slot, skip_root)
        logits, v_net, var_net = evaluator(rec["env_eval"])
        apply_eval(tree, rec, logits, v_net, var_net)
        return backward(tree, rec, v_net, var_net, skip_root)

    return simulate


def make_simulate(eng: TakEngine, evaluator: Callable, max_depth: int = 48):
    """Build ``simulate(tree, beta, forced_slot, skip_root) -> Tree``."""
    return make_kernels(eng, evaluator, max_depth)
