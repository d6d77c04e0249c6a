"""The search kernels' per-lane algorithm, in plain torch.

``ops/tree.py``'s kernels give each lane of the batch a thread block and
walk its path alone: each lane is an independent tree.  ``descend_plain``
and ``backup_plain`` state that walk one lane at a time, a Python loop
over the lane's path, with the torch operators of the batched loops
(``search/core.py`` ``descend`` and ``backward``) on the lane's rows and
values, so that the three agree bit for bit on either device.
``settle_plain`` states the settle kernel's: the leaf's Tak step square by
square and the road flood on bitboards, in Python integers with torch's
int64 shifts, so that it equals the batched ``settle`` (``TakEngine.step``
and ``terminal_kind``) bit for bit.  ``apply_eval_plain`` states the two
expansion kernels' around the top-k: a lane's legal mask from runs of
passable squares, its statistics, and its children's priors summed in the
order of torch's CUDA reduction (:func:`softmax_sum`).  The CPU tests hold
the plain statements to the batched loops, the card tests the kernels to
both.  They read the device at every level: a check, not a path of the
program.
"""

from __future__ import annotations

import torch

from ..ops.tree import reduce_layout
from ..tak.moves import DIR_DELTAS, decode_pattern
from ..tak.state import TakState
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


def _shl(a: int, k: int) -> int:
    """torch's int64 ``a << k``: 0 for a count outside [0, 64)."""
    if k < 0 or k >= 64:
        return 0
    x = (a << k) & (2**64 - 1)
    return x - 2**64 if x >> 63 else x


def _shr(a: int, k: int) -> int:
    """torch's int64 ``a >> k``: the sign for a count outside [0, 63)."""
    return a >> (63 if k < 0 or k >= 63 else k)


def _flood(cells: int, seed: int, n: int, not_first_col: int, not_last_col: int) -> int:
    """The squares of ``cells`` (a bitboard, bit ``row * n + col``)
    reachable from ``seed`` through 4-neighbours within ``cells``."""
    reach = cells & seed
    while True:
        grown = cells & (reach | ((reach << 1) & not_first_col) | ((reach >> 1) & not_last_col) | (reach << n)
                         | (reach >> n))
        if grown == reach:
            return reach
        reach = grown


def _step_plain(n: int, board: list, scalars: list, action: int) -> None:
    """``TakEngine.step`` of one state, in place: ``board`` the lists
    (height, owner, tops) over the squares, ``scalars`` [reserves (a list
    of two [stones, caps]), to_move, ply, reversible]; any action, legal or
    not, as the batched step computes it."""
    height, owner, tops = board
    reserves, to_move, ply, reversible = scalars
    s = n * n
    ch, sq = divmod(action, s)
    if ch < 3:  # a placement; the colour swaps in the first two plies
        color = 1 - to_move if ply < 2 else to_move
        piece = min(ch + 1, 3)
        height[sq], owner[sq], tops[sq] = 1, owner[sq] | color, piece
        reserves[color][int(piece == 3)] -= 1
        reversible = 0
    else:  # a spread: moves.py's pattern, dropped square by square
        patterns = 2**n - 2
        si = min(max(ch - 3, 0), 4 * patterns - 1)
        direction, mask = divmod(si, patterns)
        mask += 1
        delta = (n, 1, -n, -1)[direction]
        bits = [p for p in range(n) if mask >> p & 1]
        carry = n - bits[0]
        start = min(max(height[sq] - carry, 0), 63)
        carried = _shr(owner[sq], start) & (_shl(1, carry) - 1)
        moving_top = tops[sq]
        height[sq], owner[sq], tops[sq] = start, owner[sq] & (2**start - 1), int(start > 0)
        crushed = False
        for i, (pos, nxt) in enumerate(zip(bits, bits[1:] + [n]), start=1):
            drops, pre = nxt - pos, pos - bits[0]
            tsq = min(max(sq + i * delta, 0), s - 1)
            chunk = _shr(carried, pre) & (_shl(1, drops) - 1)
            final = i == len(bits)
            crushed |= final and tops[tsq] == 2
            owner[tsq] |= _shl(chunk, height[tsq])
            height[tsq] += drops
            tops[tsq] = moving_top if final else 1
        reversible = 0 if crushed else reversible + 1
    scalars[1:] = [1 - to_move, ply + 1, reversible]


def _terminal_kind_plain(n: int, board: list, scalars: list, half_komi: int, reversible_limit: int) -> int:
    """``TakEngine.terminal_kind`` of one state (0 ongoing, 1 win for the
    side to move, 2 loss, 3 draw), with the roads flooded on bitboards."""
    height, owner, tops = board
    reserves, to_move, _, reversible = scalars
    s = n * n
    color = [_shr(owner[q], max(height[q] - 1, 0)) & 1 for q in range(s)]
    first_col = sum(1 << (r * n) for r in range(n))
    last_col, first_row = first_col << (n - 1), 2**n - 1
    last_row = first_row << (s - n)
    masks = (n, ~first_col, ~last_col)
    roads = []
    for player in (0, 1):
        cells = sum(1 << q for q in range(s) if tops[q] in (1, 3) and color[q] == player)
        roads.append(bool(_flood(cells, first_col, *masks) & last_col)
                     or bool(_flood(cells, first_row, *masks) & last_row))
    if roads[0] or roads[1]:
        result = 1 - to_move if roads[0] and roads[1] else (0 if roads[0] else 1)
    elif all(t != 0 for t in tops) or any(sum(r) == 0 for r in reserves):
        w2 = 2 * sum(t == 1 and k == 0 for t, k in zip(tops, color))
        b2 = 2 * sum(t == 1 and k == 1 for t, k in zip(tops, color)) + half_komi
        result = 0 if w2 > b2 else (1 if b2 > w2 else 2)
    else:
        result = 2 if reversible >= reversible_limit else -1
    return 0 if result == -1 else (3 if result == 2 else (1 if result == to_move else 2))


def settle_plain(tree: Tree, loop: dict, eng, max_depth: int) -> dict:
    """``search/core.py`` ``settle`` for a Tak engine, one lane at a time,
    as the settle kernel does it: the depth clip, one visit on each edge of
    the path, the leaf's state (the root's where the lane expands its root,
    else its parent's with the leaf edge's action applied), its terminal
    kind and the terminal stores into the leaf's slot (the scratch row's
    where it is not terminal) and the root's.  Updates ``tree`` in place and
    returns ``settle``'s dict."""
    b, m, c = tree.child_visit.shape
    n, s = eng.n, eng.n * eng.n
    out = {name: loop[name].clone() for name in ("length", "stop_known", "known_f", "known_p", "known_v")}
    out["lane_eval_leaf"] = torch.zeros_like(loop["stop_leaf"])
    out["lane_eval_root"] = torch.zeros_like(loop["stop_leaf"])
    env = tree.node_env
    env_eval = TakState(*(torch.empty_like(x[:, 0]) for x in env))
    lanes = {name: loop[name].tolist() for name in ("lane_root_expand", "cur", "active", "stop_leaf",
                                                      "leaf_parent", "leaf_slot", "path_node", "path_slot")}
    for lane in range(b):
        for pn, ps in zip(lanes["path_node"][lane], lanes["path_slot"][lane]):
            if pn >= 0:
                tree.child_visit[lane, pn, max(ps, 0)] += 1
        root_expand = lanes["lane_root_expand"][lane]
        leaf_parent, leaf_slot = lanes["leaf_parent"][lane], lanes["leaf_slot"][lane]
        src = 0 if root_expand else leaf_parent
        board = [x[lane, src].tolist() for x in env[:3]]
        scalars = [x[lane, src].tolist() for x in env[3:]]
        if not root_expand:
            _step_plain(n, board, scalars, max(int(tree.child_action[lane, leaf_parent, leaf_slot]), 0))
        for i, value in enumerate(board + scalars):
            env_eval[i][lane] = torch.tensor(value, dtype=env_eval[i].dtype)
        tk = _terminal_kind_plain(n, board, scalars, eng.half_komi, eng.reversible_limit)

        if lanes["active"][lane]:  # clipped at max_depth: the current node's eval from its parent edge
            cur = lanes["cur"][lane]
            parent, slot = max(int(tree.node_parent[lane, cur]), 0), max(int(tree.node_slot[lane, cur]), 0)
            out["stop_known"][lane] = True
            out["known_f"][lane] = loop["cur_flag"][lane]
            out["known_p"][lane] = tree.child_ply[lane, parent, slot]
            out["known_v"][lane] = tree.child_value[lane, parent, slot]
            out["length"][lane] = max_depth
            tree.overflow[lane] += 1
        leaf_term = lanes["stop_leaf"][lane] and tk != 0
        root_term = root_expand and tk != 0
        node = leaf_parent if leaf_term else m - 1
        tree.child_flag[lane, node, leaf_slot] = tk
        tree.child_ply[lane, node, leaf_slot] = 0
        tree.child_std[lane, node, leaf_slot] = 0.0
        if root_term:
            tree.root_flag[lane], tree.root_ply[lane], tree.root_std[lane] = tk, 0, 0.0
        if leaf_term:
            out["stop_known"][lane] = True
            out["known_f"][lane], out["known_p"][lane], out["known_v"][lane] = tk, 0, 0.0
        out["lane_eval_leaf"][lane] = lanes["stop_leaf"][lane] and not leaf_term
        out["lane_eval_root"][lane] = root_expand and not root_term
    return dict(path_node=loop["path_node"], path_slot=loop["path_slot"], **out,
                lane_root_expand=loop["lane_root_expand"], leaf_parent=loop["leaf_parent"],
                leaf_slot=loop["leaf_slot"], env_eval=env_eval)


def legal_mask_plain(eng, state: TakState) -> torch.Tensor:
    """``TakEngine.legal_mask`` of one state (fields without a batch
    dimension), as the mask kernel decides it: bool[num_actions].  A
    spread's drop pattern gives its direction, its ``k`` drop squares, its
    ``carry`` and its ``last`` drop (moves.py ``decode_pattern``); it is
    legal where the mover controls the square outside the swap plies,
    ``carry <= min(height, n)``, the run of passable squares (empty or flat)
    from the square's neighbour covers the first ``k - 1`` drops, and the
    ``k``-th square is passable, or is a wall that a lone capstone crushes
    (``last == 1``)."""
    n, s = eng.n, eng.n * eng.n
    height, owner, tops = (x.tolist() for x in state[:3])
    me, swap = int(state.to_move), int(state.ply) < 2
    stones, caps = state.reserves[me].tolist()
    color = [_shr(owner[q], max(height[q] - 1, 0)) & 1 for q in range(s)]
    legal = [tops[q] == 0 and (swap or stones > 0) for q in range(s)]
    legal += [tops[q] == 0 and not swap and stones > 0 for q in range(s)]
    legal += [tops[q] == 0 and not swap and caps > 0 for q in range(s)]
    directions = DIR_DELTAS.tolist()
    run = [[0] * s for _ in directions]  # passable squares in a row from q's neighbour
    for d, (dr, dc) in enumerate(directions):
        for q in range(s):
            r, c = divmod(q, n)
            while 0 <= r + dr < n and 0 <= c + dc < n and tops[(r + dr) * n + c + dc] <= 1:
                r, c = r + dr, c + dc
                run[d][q] += 1
    patterns = 2**n - 2
    for si in range(4 * patterns):
        d, mask = divmod(si, patterns)
        drops = decode_pattern(mask + 1, n)
        k, carry, last = len(drops), sum(drops), drops[-1]
        dr, dc = directions[d]
        for q in range(s):
            ok = tops[q] > 0 and color[q] == me and not swap and carry <= min(height[q], n) and run[d][q] >= k - 1
            if ok and run[d][q] < k:  # the k-th square: off the board, a wall or a capstone
                r, c = divmod(q, n)
                r, c = r + k * dr, c + k * dc
                ok = last == 1 and tops[q] == 3 and 0 <= r < n and 0 <= c < n and tops[r * n + c] == 2
            legal.append(ok)
    return torch.tensor(legal, device=state.tops.device)


def softmax_sum(ex: torch.Tensor, rows: int, row: int) -> torch.Tensor:
    """The sum of ``ex`` (float32 [c], non-negative) in the order torch's
    CUDA reduction sums row ``row`` of a contiguous [rows, c] tensor whose
    first row lies on a 16-byte boundary (:func:`reduce_layout`).  Thread
    ``t`` of the row's ``width`` keeps four accumulators: vectorised, term
    ``4 * j + i`` of its vectors ``t, t + width, ...`` goes to accumulator
    ``i`` (where the row starts off a 16-byte boundary, threads ``shift`` to
    3 first take its leading ``4 - shift`` terms; the ``c % 4`` terms left
    over go one a thread to accumulator 0); else terms ``t + (4 j + i)
    width`` to accumulator ``i`` while a thread has four, then one each.  A
    thread adds its accumulators in order, and the row's partials are
    added pairwise, halving: ``p[t] + p[t + width / 2]``."""
    c = ex.shape[0]
    width, vectorised = reduce_layout(rows, c)
    zero = ex.new_zeros(())
    partial = []
    for t in range(width):
        acc = [zero] * 4
        if vectorised:
            base, end, shift = 0, c, row * c % 4
            if shift:
                if shift <= t < 4:
                    acc[0] = zero + ex[t - shift]
                base, end = 4 - shift, c - 4 + shift
            j = t
            while 4 * j + 3 < end:
                acc = [acc[i] + ex[base + 4 * j + i] for i in range(4)]
                j += width
            if end - end % 4 + t < end:
                acc[0] = acc[0] + ex[base + end - end % 4 + t]
        else:
            j = t
            while j + 3 * width < c:
                acc = [acc[i] + ex[j + i * width] for i in range(4)]
                j += 4 * width
            for i in range(4):
                if j >= c:
                    break
                acc[i] = acc[i] + ex[j]
                j += width
        partial.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    while len(partial) > 1:
        half = len(partial) // 2
        partial = [partial[t] + partial[t + half] for t in range(half)]
    return partial[0]


def apply_eval_plain(tree: Tree, rec: dict, logits, v_net, var_net, eng, topk_fn) -> Tree:
    """``search/core.py`` ``apply_eval`` for a Tak engine as the expansion
    kernels do it, one lane at a time around ``topk_fn``: each lane's legal
    mask (:func:`legal_mask_plain`) and masked logits; after the top-k, the
    leaf's and the root's statistics, the children's priors (max, ``exp``,
    the sum in torch's CUDA order, :func:`softmax_sum`, one division), and
    the guarded expansion's stores into the allocated row (the root's where
    the lane expands its root; the scratch row where it expands nothing).
    Updates ``tree`` in place."""
    b, m, c = tree.child_visit.shape
    capacity = m - 1
    env = rec["env_eval"]
    v_net, sd_net = v_net.float(), torch.sqrt(var_net.float())
    masked = torch.empty((b, eng.num_actions), dtype=torch.float32, device=tree.child_visit.device)
    n_legal = []
    for lane in range(b):
        legal = legal_mask_plain(eng, env.map(lambda x: x[lane]))
        masked[lane] = torch.where(legal, logits[lane].float(), NEG)
        n_legal.append(int(legal.sum()))
    top_vals, top_idx = topk_fn(masked, c)
    flags = {k: rec[k].tolist() for k in ("lane_eval_leaf", "lane_eval_root", "lane_root_expand", "leaf_parent",
                                           "leaf_slot")}
    for lane in range(b):
        parent, slot = flags["leaf_parent"][lane], flags["leaf_slot"][lane]
        eval_leaf, eval_root = flags["lane_eval_leaf"][lane], flags["lane_eval_root"][lane]
        root_expand = flags["lane_root_expand"][lane]
        n_leaf = tree.child_visit[lane, parent, slot].float().clamp(min=1.0)
        old_v, old_s = tree.child_value[lane, parent, slot].clone(), tree.child_std[lane, parent, slot].clone()
        leaf_v = old_v + (v_net[lane] - old_v) / n_leaf
        leaf_s = old_s + (sd_net[lane] - old_s) / n_leaf
        rn = tree.root_visit[lane].float().clamp(min=1.0)
        root_v = tree.root_value[lane] + (v_net[lane] - tree.root_value[lane]) / rn
        root_s = tree.root_std[lane] + (sd_net[lane] - tree.root_std[lane]) / rn
        tree.child_value[lane, parent if eval_leaf else capacity, slot] = leaf_v
        tree.child_std[lane, parent if eval_leaf else capacity, slot] = leaf_s
        if eval_root:
            tree.root_value[lane], tree.root_std[lane] = root_v, root_s
        v_after, s_after = (root_v, root_s) if eval_root else (leaf_v, leaf_s)

        vals = top_vals[lane]
        valid = vals > NEG / 2
        mx = torch.where(valid, vals, -torch.inf).max()
        ex = torch.where(valid, torch.exp(vals - mx), 0.0)
        prob = ex / softmax_sum(ex, b, lane).clamp(min=1e-30)

        already = int(tree.child_node[lane, parent, slot]) >= 0 and not root_expand
        ptr = int(tree.alloc_ptr[lane])
        can_expand = root_expand or ptr < int(tree.free_count[lane])
        evaluated = eval_leaf or eval_root
        expanding = evaluated and can_expand and not already
        node = (0 if root_expand else int(tree.free_rows[lane, min(max(ptr, 0), m - 1)])) if expanding else capacity
        tree.child_action[lane, node] = torch.where(valid, top_idx[lane], -1)
        tree.child_logit[lane, node] = torch.where(valid, vals, 0.0)
        tree.child_prob[lane, node] = prob
        for name in ("child_visit", "child_flag", "child_ply"):
            getattr(tree, name)[lane, node] = 0
        tree.child_value[lane, node] = -v_after
        tree.child_std[lane, node] = s_after
        tree.child_node[lane, node] = -1
        leaf_expand = expanding and eval_leaf
        tree.node_parent[lane, node] = parent if leaf_expand else -1
        tree.node_slot[lane, node] = slot if leaf_expand else -1
        tree.node_incomplete[lane, node] = n_legal[lane] > c
        for pool, x in zip(tree.node_env, env):
            pool[lane, node] = x[lane]
        tree.child_node[lane, parent if leaf_expand else capacity, slot] = node
        tree.node_count[lane] += int(leaf_expand)
        tree.alloc_ptr[lane] += int(leaf_expand)
        tree.node_live[lane, node] = expanding
        tree.overflow[lane] += int(evaluated and not can_expand)
    return tree
