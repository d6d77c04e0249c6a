"""The descent and backup kernels' per-lane algorithm, in plain torch.

``ops/tree.py``'s kernels give each lane of the batch a thread block and
walk its path alone: each lane is an independent tree.  ``descend_plain``
and ``backup_plain`` state that walk one lane at a time, a Python loop
over the lane's path, with the torch operators of the batched loops
(``search/core.py`` ``descend`` and ``backward``) on the lane's rows and
values, so that the three agree bit for bit on either device.  The CPU
tests hold the plain statements to the batched loops, the card tests the
kernels to both.  They read the device at every level: a check, not a
path of the program.
"""

from __future__ import annotations

import torch

from . import eval as ev
from .core import NEG, _descent_buffers
from .tree import Tree


def descend_plain(tree: Tree, beta, forced_slot, skip_root: bool, max_depth: int) -> dict:
    """The descent of every lane, one lane at a time: from the root to
    the first unexpanded child or to ``max_depth``.  Adds the root's visit
    unless ``skip_root`` and returns :func:`core._descent_buffers`' fields
    (``active``: the lanes clipped at ``max_depth``)."""
    b, m, c = tree.child_visit.shape
    dev = tree.child_visit.device
    o = _descent_buffers(b, max_depth, dev)
    for name in o:
        o[name].fill_(-1 if name.startswith("path_") else 0)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev).expand(b)
    rows = (tree.child_action, tree.child_flag, tree.child_ply, tree.child_value, tree.child_prob,
            tree.child_std, tree.child_visit, tree.child_node)
    for lane in range(b):
        if not skip_root:
            tree.root_visit[lane] += 1
        expanded = bool((tree.child_action[lane, 0] >= 0).any())
        cur, cur_flag, cur_visit = 0, tree.root_flag[lane].clone(), tree.root_visit[lane].clone()
        o["lane_root_expand"][lane] = not expanded and int(cur_flag) == ev.VALUE
        active, d = expanded, 0
        while d < max_depth and active:
            action, flag, ply, value, prob, std, visit, node = (x[lane, cur] for x in rows)
            valid = action >= 0
            q = ev.negated_float(flag, ply, value)
            pv = cur_visit.float()
            c_rate = torch.log((1.0 + pv + 500.0) / 500.0) + 4.0
            u = c_rate * prob * torch.sqrt(pv) / (1.0 + visit)
            score = q + u + beta[lane] * std
            unpruned = valid & ~((flag == ev.WIN) & (cur_flag != ev.LOSS))
            # An incomplete node may hold only proven-win children.
            pick = unpruned if bool(unpruned.any()) else valid
            slot = int(torch.where(pick, score, NEG).argmax())
            if forced_slot is not None and d == 0:
                slot = int(forced_slot[lane])
            o["path_node"][lane, d] = cur
            o["path_slot"][lane, d] = slot
            if int(node[slot]) < 0:  # the first unexpanded child: a known stop or a leaf
                o["length"][lane] = d + 1
                if int(flag[slot]) != ev.VALUE:
                    o["stop_known"][lane] = True
                    o["known_f"][lane], o["known_p"][lane], o["known_v"][lane] = flag[slot], ply[slot], value[slot]
                else:
                    o["stop_leaf"][lane] = True
                    o["leaf_parent"][lane], o["leaf_slot"][lane] = cur, slot
                active = False
            else:
                cur, cur_flag, cur_visit = int(node[slot]), flag[slot].clone(), visit[slot] + 1
            d += 1
        o["cur"][lane], o["cur_flag"][lane], o["active"][lane] = cur, cur_flag, active
    return o


def backup_plain(tree: Tree, rec: dict, v_net, var_net, skip_root: bool, mode: str = "all") -> Tree:
    """The backup of every lane that ``mode`` selects ("all": known stops
    and evaluated leaves; "known"; "leaf"), one lane at a time, from the
    lane's own path length down to the root (to depth 1 under
    ``skip_root``): at each level the exact solver over the node's
    children, then the parent slot's (or the root's) statistics and the
    value propagated upward."""
    known = rec["stop_known"]
    selected = {"all": known | rec["lane_eval_leaf"], "known": known, "leaf": rec["lane_eval_leaf"]}[mode]
    v_net, var_net = v_net.float(), var_net.float()
    for lane in range(tree.batch_size):
        if not bool(selected[lane]):
            continue
        k = known[lane]
        pf = torch.where(k, rec["known_f"][lane], ev.VALUE)
        pp = torch.where(k, rec["known_p"][lane], 0)
        pv = torch.where(k, rec["known_v"][lane], ev.DISCOUNT * v_net[lane])
        pvar = torch.where(k, 0.0, ev.DISCOUNT**2 * var_net[lane])
        for j in range(int(rec["length"][lane]) - 1, (1 if skip_root else 0) - 1, -1):
            node_j = max(int(rec["path_node"][lane, j]), 0)
            ca, cfl, cpl, cva = (x[lane, node_j] for x in (tree.child_action, tree.child_flag,
                                                           tree.child_ply, tree.child_value))
            validc = ca >= 0
            all_known = bool((~validc | (cfl != ev.VALUE)).all()) and bool(validc.any())
            trigger = int(pf) == ev.LOSS or (all_known and not bool(tree.node_incomplete[lane, node_j]))
            mi = int(ev.argmin_eval(cfl, cpl, cva, validc))
            solved_f, solved_p, solved_v = ev.negate(cfl[mi].clone(), cpl[mi].clone(), cva[mi].clone())

            if j == 0:
                at = (tree.root_flag, tree.root_ply, tree.root_value, tree.root_std), (lane,)
                svisit = tree.root_visit[lane]
            else:
                pn = max(int(rec["path_node"][lane, j - 1]), 0)
                ps = max(int(rec["path_slot"][lane, j - 1]), 0)
                at = (tree.child_flag, tree.child_ply, tree.child_value, tree.child_std), (lane, pn, ps)
                svisit = tree.child_visit[lane, pn, ps]
            arrays, idx = at
            sf, sp, sv, ss = (x[idx].clone() for x in arrays)

            new_f = solved_f if trigger else sf
            new_p = solved_p if trigger else sp
            known_now = int(new_f) != ev.VALUE
            negated = ev.negated_float(pf, pp, pv)
            visf = svisit.float().clamp(min=1.0)
            val_upd = sv + (negated - sv) / visf
            std_upd = ss + (torch.sqrt(pvar) - ss) / visf
            new_v = solved_v if trigger else (sv if known_now else val_upd)
            new_s = torch.zeros_like(ss) if trigger else (ss if known_now else std_upd)
            for x, val in zip(arrays, (new_f, new_p, new_v, new_s)):
                x[idx] = val

            if known_now:
                pf, pp, pv, pvar = new_f, new_p, new_v, new_s * new_s
            else:
                pf, pp, pv, pvar = torch.full_like(pf, ev.VALUE), torch.zeros_like(pp), negated * ev.DISCOUNT, \
                    pvar * ev.DISCOUNT**2
    return tree
