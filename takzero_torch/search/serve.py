"""Wavefront serve-path kernel: K simulations per evaluator call, pipelined.

Counterpart of ``takzero_tpu/search/serve.py`` (``make_serve_chunk``
:54-516), the kernel behind TEI's search.  The K descents of one chunk run
as a *wavefront*: path k starts at iteration k, every active path advances
one level per iteration, and its visit increment commits at once, so a path
choosing at depth d sees the depth-d visits of every earlier path, exactly
as K sequential descents would.  Two paths never occupy the same node in
the same iteration, so the per-level visit adds never collide.

Four phases, as in JAX:

* A, the descent: a loop of exactly ``K + max_depth`` iterations with no
  host read (the trip count is fixed, inactive paths idle on the scratch
  row);
* B, ONE evaluator call over the B*K leaves (kernel B inside the network
  evaluator);
* C, leaf statistics and a deduplicated expansion: paths that stopped at
  the same (parent, slot) form one group whose first path expands, through
  ONE batched top-k call over f32[B*K, A] (kernel A unless ``topk``
  chooses another, ``core.make_topk``);
* D, a level-synchronised backward from the deepest stop to the root; its
  one host read is the deepest level, ``jmax``.

JAX's two documented deviations from ``simulate_batch`` (:27-34) hold
here too: known stops back up at the end of the chunk, and duplicate
contributions to one edge combine as ``v += (sum(a_i) - m*v) / n``.

Trees are updated in place.  Losers of a group and inactive paths write to
the scratch row (the last pool row), so duplicate indices in the stores
land only there, where the content is garbage by design.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..tak.engine import TakEngine
from ..utils.profile import host_item, span
from . import eval as ev
from .core import (_betas, backed_up_eval, expansion_children, leaf_propagated, make_topk, propagated,
                   select_child, solve_children)
from .tree import Tree


def _first_true(same: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (``jnp.argmax`` of a bool
    matrix); torch's argmax returns the first maximal index."""
    return same.to(torch.uint8).argmax(-1)


def make_serve_chunk(eng: TakEngine, evaluator: Callable, k: int, max_depth: int = 64, topk: str = "auto"):
    """Build ``serve_chunk(tree, beta) -> Tree`` running ``k`` simulations.

    Lanes whose root is expanded run ``k`` simulations each (run one plain
    ``simulate`` on a fresh tree first, as the TEI driver does); lanes with
    an unexpanded root (a terminal position) are left as they are.
    Expansion uses ``make_topk(topk)``.
    """
    topk_fn = make_topk(topk)
    K = k

    def serve_chunk(tree: Tree, beta) -> Tree:
        b, m, c = tree.child_visit.shape
        dev = tree.child_visit.device
        bar = torch.arange(b, device=dev)[:, None]  # [B, 1]
        kio = torch.arange(K, dtype=torch.int32, device=dev)[None, :]  # [1, K]
        dio = torch.arange(max_depth, dtype=torch.int32, device=dev)
        scratch = m - 1
        beta = _betas(tree, beta)
        i32 = dict(dtype=torch.int32, device=dev)

        # A lane whose root was never expanded has no edges to descend: gate
        # it off entirely (every path would fabricate a leaf at (0, 0)).
        root_ok = (tree.child_action[:, 0, :] >= 0).any(-1)  # [B]

        # --------------------------------------------------------------
        # Phase A: pipelined descent, K + max_depth iterations.
        # --------------------------------------------------------------
        alive = root_ok[:, None].expand(b, K).clone()
        cur = torch.zeros((b, K), dtype=torch.int64, device=dev)
        cur_flag = tree.root_flag[:, None].expand(b, K).clone()
        # Path k's root-level parent count: the chunk's initial visits plus
        # the k+1 activation increments visible to it (its own included).
        # Read before the root's visits are raised by K below.
        cur_visit = tree.root_visit[:, None] + kio + 1
        path_node = torch.full((b, K, max_depth), -1, **i32)
        path_slot = torch.full((b, K, max_depth), -1, **i32)
        length = torch.zeros((b, K), **i32)
        stop_known = torch.zeros((b, K), dtype=torch.bool, device=dev)
        known_f = torch.zeros((b, K), **i32)
        known_p = torch.zeros((b, K), **i32)
        known_v = torch.zeros((b, K), dtype=torch.float32, device=dev)
        stop_leaf = torch.zeros_like(stop_known)
        leaf_parent = torch.zeros_like(cur)
        leaf_slot = torch.zeros_like(cur)
        clip_count = torch.zeros((b,), **i32)
        barK = bar.expand(b, K)

        # Each phase is a span (its host time under torch.profiler).
        with span("serve_chunk.A"):
            for i in range(K + max_depth):
                d = i - kio  # [1, K] depth of each path this iteration
                active = alive & (d >= 0)
                curc = torch.where(active, cur, scratch)

                slot, (cn, cf, cp, cv, cvisit) = select_child(tree, bar, curc, cur_visit, cur_flag,
                                                               beta[:, None])  # [B, K]
                cvisit = cvisit + 1
                rec = active[:, :, None] & (dio == d[:, :, None])  # [B, K, D]
                path_node = torch.where(rec, cur[:, :, None].to(torch.int32), path_node)
                path_slot = torch.where(rec, slot[:, :, None].to(torch.int32), path_slot)

                unexp = cn < 0
                new_known = active & unexp & (cf != ev.VALUE)
                new_leaf = active & unexp & (cf == ev.VALUE)
                clip_now = active & ~unexp & (d + 1 >= max_depth)
                cont = active & ~unexp & ~clip_now
                stopped = new_known | new_leaf | clip_now
                known_now = new_known | clip_now

                # This level's visit increments; inactive paths add 0 to the
                # scratch row.
                tree.child_visit.index_put_((barK, curc, slot), active.to(torch.int32), accumulate=True)

                alive = alive & ~stopped
                length = torch.where(stopped, d + 1, length)
                stop_known = stop_known | known_now
                # Depth-clipped paths back up the reached node's own eval (flag,
                # value and ply from its edge), as ``forward`` does.
                known_f = torch.where(known_now, cf, known_f)
                known_p = torch.where(known_now, cp, known_p)
                known_v = torch.where(known_now, cv, known_v)
                stop_leaf = stop_leaf | new_leaf
                leaf_parent = torch.where(new_leaf, cur, leaf_parent)
                leaf_slot = torch.where(new_leaf, slot, leaf_slot)
                clip_count += clip_now.sum(1, dtype=torch.int32)
                cur = torch.where(cont, cn.to(torch.int64), cur)
                cur_flag = torch.where(cont, cf, cur_flag)
                cur_visit = torch.where(cont, cvisit, cur_visit)

            tree.root_visit.add_(K * root_ok.to(torch.int32))
            tree.overflow.add_(clip_count)

            # Leaf environments and terminal discovery (one batched step).
            lpc = torch.where(stop_leaf, leaf_parent, 0)
            penv = tree.node_env.map(lambda a: a[bar, lpc].reshape((b * K,) + a.shape[2:]))
            la = tree.child_action[bar, lpc, leaf_slot].clamp(min=0)
            env_eval = eng.step(penv, la.reshape(b * K))  # [B*K] flattened
            tk = eng.terminal_kind(env_eval).reshape(b, K)

            leaf_term = stop_leaf & (tk != 0)
            t_node = torch.where(leaf_term, leaf_parent, scratch)
            tree.child_flag[bar, t_node, leaf_slot] = tk.to(torch.int32)
            tree.child_ply[bar, t_node, leaf_slot] = 0
            tree.child_std[bar, t_node, leaf_slot] = 0.0
            stop_known = stop_known | leaf_term
            known_f = torch.where(leaf_term, tk.to(torch.int32), known_f)
            known_p = torch.where(leaf_term, 0, known_p)
            known_v = torch.where(leaf_term, 0.0, known_v)
            lane_eval = stop_leaf & ~leaf_term

        # --------------------------------------------------------------
        # Phase B: ONE evaluator call over all B*K leaves.
        # --------------------------------------------------------------
        with span("serve_chunk.B"):
            logits, v_net, var_net = evaluator(env_eval)
            v_net = v_net.float().reshape(b, K)
            var_net = var_net.float().reshape(b, K)

        # --------------------------------------------------------------
        # Phase C: leaf statistics and the deduplicated expansion.
        # --------------------------------------------------------------
        with span("serve_chunk.C"):
            # Paths that stopped at the same (parent, slot) form one group;
            # unique dummy keys keep the other paths ungrouped.
            gkey = torch.where(lane_eval, leaf_parent * c + leaf_slot, -1 - kio.to(torch.int64))
            same = gkey[:, :, None] == gkey[:, None, :]  # [B, K, K]
            is_first = _first_true(same) == kio
            se = same & lane_eval[:, None, :]
            m_cnt = se.sum(2).float()
            sum_v = torch.where(se, v_net[:, None, :], 0.0).sum(2)
            sum_s = torch.where(se, torch.sqrt(var_net)[:, None, :], 0.0).sum(2)

            n_leaf = tree.child_visit[bar, lpc, leaf_slot].float()
            old_v = tree.child_value[bar, lpc, leaf_slot]
            old_s = tree.child_std[bar, lpc, leaf_slot]
            denom = n_leaf.clamp(min=1.0)
            new_leaf_v = old_v + (sum_v - m_cnt * old_v) / denom
            new_leaf_s = old_s + (sum_s - m_cnt * old_s) / denom
            wfirst = is_first & lane_eval
            w_node = torch.where(wfirst, leaf_parent, scratch)
            tree.child_value[bar, w_node, leaf_slot] = new_leaf_v
            tree.child_std[bar, w_node, leaf_slot] = new_leaf_s

            # Expansion: one top-k (kernel A by default) over all leaves.
            legal = eng.legal_mask(env_eval)  # [B*K, A]
            valid_child, top_vals, top_idx, probs = expansion_children(logits, legal, c, topk_fn, (b, K))
            legal_count = legal.sum(-1).reshape(b, K)

            want = wfirst.to(torch.int32)
            pos = want.cumsum(1, dtype=torch.int32) - want
            idxp = tree.alloc_ptr[:, None] + pos
            can = idxp < tree.free_count[:, None]
            new_node = tree.free_rows[bar, idxp.clamp(0, m - 1).to(torch.int64)]
            expanding = wfirst & can
            nn_ = torch.where(expanding, new_node, scratch).to(torch.int64)

            # The new rows first, then the parent edges' links (disjoint rows:
            # the new rows are free, the parents live), as JAX orders them.
            tree.child_node[bar, nn_] = -1
            link = torch.where(expanding, leaf_parent, scratch)
            tree.child_node[bar, link, leaf_slot] = torch.where(expanding, new_node, -1)
            tree.child_action[bar, nn_] = torch.where(valid_child, top_idx, -1)
            tree.child_logit[bar, nn_] = torch.where(valid_child, top_vals, 0.0)
            tree.child_prob[bar, nn_] = probs
            tree.child_visit[bar, nn_] = 0
            tree.child_flag[bar, nn_] = 0
            tree.child_ply[bar, nn_] = 0
            tree.child_value[bar, nn_] = -new_leaf_v[:, :, None].expand(b, K, c)
            tree.child_std[bar, nn_] = new_leaf_s[:, :, None].expand(b, K, c)
            tree.node_parent[bar, nn_] = torch.where(expanding, leaf_parent, -1).to(torch.int32)
            tree.node_slot[bar, nn_] = torch.where(expanding, leaf_slot, -1).to(torch.int32)
            tree.node_incomplete[bar, nn_] = legal_count > c
            for pool, val in zip(tree.node_env, env_eval):
                pool[bar, nn_] = val.reshape((b, K) + val.shape[1:])
            grown = expanding.sum(1, dtype=torch.int32)
            tree.node_count.add_(grown)
            tree.alloc_ptr.add_(grown)
            tree.node_live[bar, nn_] = expanding
            tree.overflow.add_((wfirst & ~can).sum(1, dtype=torch.int32))

        # --------------------------------------------------------------
        # Phase D: level-synchronised backward.
        # --------------------------------------------------------------
        with span("serve_chunk.D"):
            active_bwd = stop_known | lane_eval
            prop = leaf_propagated(stop_known, known_f, known_p, known_v, v_net, var_net)
            jmax = host_item(torch.where(active_bwd, length, 0).max())  # the one host read

            for j in range(jmax - 1, -1, -1):
                part = active_bwd & (j < length)
                node_j = torch.where(part, path_node[:, :, j], scratch).clamp(min=0).to(torch.int64)
                is_root = j == 0
                if is_root:
                    sf = tree.root_flag[:, None].expand(b, K)
                    sp = tree.root_ply[:, None].expand(b, K)
                    sv = tree.root_value[:, None].expand(b, K)
                    ss = tree.root_std[:, None].expand(b, K)
                    svisit = tree.root_visit[:, None].expand(b, K)
                else:
                    pn = path_node[:, :, j - 1].clamp(min=0).to(torch.int64)
                    ps = path_slot[:, :, j - 1].clamp(min=0).to(torch.int64)
                    sf, sp, sv, ss, svisit = (
                        a[bar, pn, ps] for a in (
                            tree.child_flag, tree.child_ply, tree.child_value, tree.child_std, tree.child_visit,
                        )
                    )

                pf, pp, pv, pvar = prop
                closed, solved = solve_children(tree.child_flag[bar, node_j], tree.child_ply[bar, node_j],
                                                tree.child_value[bar, node_j], tree.child_action[bar, node_j] >= 0,
                                                tree.node_incomplete[bar, node_j])
                trigger = (pf == ev.LOSS) | closed

                # Paths updating the same edge this level (same node_j) combine.
                gkey2 = torch.where(part, node_j, -1 - kio.to(torch.int64))
                same2 = gkey2[:, :, None] == gkey2[:, None, :]
                sp2 = same2 & part[:, None, :]
                grp_trigger = (sp2 & trigger[:, None, :]).any(2)

                negated = ev.negated_float(pf, pp, pv)
                m_cnt2 = sp2.sum(2).float()
                sum_neg = torch.where(sp2, negated[:, None, :], 0.0).sum(2)
                sum_sq = torch.where(sp2, torch.sqrt(pvar)[:, None, :], 0.0).sum(2)
                visf = svisit.float().clamp(min=1.0)
                val_upd = sv + (sum_neg - m_cnt2 * sv) / visf
                std_upd = ss + (sum_sq - m_cnt2 * ss) / visf
                new = backed_up_eval(grp_trigger, solved, (sf, sp, sv, ss), val_upd, std_upd)
                _, new_f, new_p, new_v, new_s = new

                writer = part & (_first_true(same2) == kio)
                if is_root:
                    # Every participating path sits at the root: one writer.
                    rooted = writer.any(1)
                    for arr, x in ((tree.root_flag, new_f), (tree.root_ply, new_p),
                                   (tree.root_value, new_v), (tree.root_std, new_s)):
                        picked = torch.where(writer, x, torch.zeros_like(x)).sum(1).to(arr.dtype)
                        arr.copy_(torch.where(rooted, picked, arr))
                else:
                    wn = torch.where(writer, pn, scratch)
                    tree.child_flag[bar, wn, ps] = new_f.to(torch.int32)
                    tree.child_ply[bar, wn, ps] = new_p.to(torch.int32)
                    tree.child_value[bar, wn, ps] = new_v
                    tree.child_std[bar, wn, ps] = new_s

                prop = propagated(part, new, negated, prop)
        return tree

    return serve_chunk
