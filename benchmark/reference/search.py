"""Plain search arithmetic in float32 numpy: the game-theoretic
evaluation triple (flag, ply, value) with the reference's negation,
discount and order (takzero/src/search/eval.rs), the improved policy of
Gumbel search, the UBE target and the selection of the weighted-random
plies (takzero/src/search/policy.rs, selfplay/src/main.rs), the Gumbel
candidates and the visits that sequential halving gives them, and the
backup of a node's statistics from its own evaluation and its children's.
Nothing here imports the program."""

from __future__ import annotations

import numpy as np
import torch

VALUE, WIN, LOSS, DRAW = 0, 1, 2, 3
DISCOUNT = np.float32(0.997)
CONTEMPT = np.float32(-0.05)
F32 = np.float32


def to_float(flag, ply, value):
    flag, ply, value = np.asarray(flag), np.asarray(ply), np.asarray(value, F32)
    sign = np.where(flag == WIN, F32(1), np.where(flag == LOSS, F32(-1), F32(0)))
    base = np.where(flag == VALUE, value, sign)
    disc = np.where(flag == VALUE, F32(1), np.power(DISCOUNT, ply.astype(F32)))
    return (base * disc).astype(F32)


def negate(flag, ply, value):
    flag, ply = np.asarray(flag), np.asarray(ply)
    nf = np.where(flag == WIN, LOSS, np.where(flag == LOSS, WIN, flag))
    return nf, np.where(flag == VALUE, ply, ply + 1), -np.asarray(value, F32)


def q_of_child(flag, ply, value):
    """A child's evaluation from the parent's side."""
    return to_float(*negate(flag, ply, value))


def order_keys(flag, ply, value):
    plyf = np.asarray(ply).astype(F32)
    primary = np.where(flag == LOSS, F32(-2), np.where(flag == WIN, F32(2),
                       np.where(flag == DRAW, CONTEMPT, np.asarray(value, F32))))
    secondary = np.where(flag == LOSS, plyf, np.where((flag == WIN) | (flag == DRAW), -plyf, F32(0)))
    return primary.astype(F32), secondary.astype(F32)


def argmin_eval(flag, ply, value, valid) -> int:
    primary, secondary = order_keys(flag, ply, value)
    primary = np.where(valid, primary, F32(3.4e38))
    tie = primary == primary.min()
    secondary = np.where(tie & valid, secondary, F32(3.4e38))
    return int(np.argmin(secondary))


def improved_policy(root: dict, logits, visitations: float):
    """Softmax over the valid root slots of ``logits + completed_q *
    sqrt(visitations)``; an unvisited, unexpanded, unknown child takes the
    root's own evaluation."""
    valid = root["action"] >= 0
    needs_init = (root["node"] < 0) & (root["flag"] == VALUE) & (root["visit"] == 0)
    root_f = to_float(root["root_flag"], root["root_ply"], root["root_value"])
    completed = np.where(needs_init, root_f, q_of_child(root["flag"], root["ply"], root["value"]))
    score = np.where(valid, np.asarray(logits, F32) + completed * np.sqrt(F32(visitations)), -np.inf).astype(F32)
    e = np.where(valid, np.exp(score - score.max()), F32(0))
    return e / max(e.sum(), F32(1e-30))


def ube_target(root: dict, beta: float) -> float:
    valid = root["action"] >= 0
    q = q_of_child(root["flag"], root["ply"], root["value"])
    score = np.where(valid, q + F32(beta) * np.asarray(root["std"], F32), -np.inf)
    std = F32(root["std"][int(np.argmax(score))])
    solved = root["root_flag"] != VALUE or not valid.any()
    return 0.0 if solved else float(std * std)


def best_slot(root: dict) -> int:
    valid = root["action"] >= 0
    if root["root_flag"] != VALUE:
        return argmin_eval(root["flag"], root["ply"], root["value"], valid)
    visits = np.where(valid, root["visit"], -1)
    if visits.max() <= 0:
        return int(np.argmax(np.where(valid, root["prob"], F32(-1))))
    return int(np.argmax(visits))


def weighted_random_slot(root: dict, gumbel, threshold: int = 32, allowed_drop: float = 0.5) -> int:
    """The slot of a weighted-random ply: proportional to visits among the
    children visited ``threshold`` times that are no proven win and not
    better for the opponent than the best child by more than
    ``allowed_drop``; ``gumbel`` is the categorical draw's noise."""
    valid = root["action"] >= 0
    flag, ply, value = root["flag"], root["ply"], np.asarray(root["value"], F32)
    b = argmin_eval(flag, ply, value, valid)
    bv = value[b] + (F32(allowed_drop) if flag[b] == VALUE else F32(0))
    bprim, bsec = order_keys(flag[b], ply[b], bv)
    cprim, csec = order_keys(flag, ply, value)
    exceeds = (cprim > bprim) | ((cprim == bprim) & (csec > bsec))
    ok = valid & (root["visit"] >= threshold) & (flag != WIN) & ~exceeds
    weights = np.where(ok, root["visit"].astype(F32), F32(0))
    if root["root_flag"] != VALUE or weights.sum() <= 0:
        return best_slot(root)
    return int(np.argmax(np.log(np.maximum(weights, F32(1e-30))) + np.asarray(gumbel, F32)))


def improved_policy_visitations(sampled_actions: int, budget: int) -> float:
    """Visits of each of the last two candidates of sequential halving:
    ``log2(k)`` phases share the budget, phase i gives ``budget / log2(k) /
    (k / 2^i)`` visits to each of its ``k / 2^i`` candidates."""
    k, phases = sampled_actions, sampled_actions.bit_length() - 1
    per_phase = budget // phases
    return float(sum(per_phase // (k >> i) for i in range(phases)))


def gumbel_candidates(logits, gumbel, valid, k: int) -> np.ndarray:
    """Slots of the ``k`` largest ``logit + gumbel`` among the valid root
    slots (ties to the lower slot), at most as many as are valid."""
    x = np.where(valid, np.asarray(logits, F32) + np.asarray(gumbel, F32), -np.inf)
    return np.argsort(-x, kind="stable")[: min(k, int(np.sum(valid)))]


def halving_visits(k: int, budget: int) -> np.ndarray:
    """The visits of the ``k`` candidates after sequential halving, largest
    first: ``log2(k)`` phases share the budget evenly, phase i gives each of
    its ``k / 2^i`` candidates ``budget / log2(k) / (k / 2^i)`` visits and
    then drops half of them; the last phase keeps both."""
    phases = k.bit_length() - 1
    out, cum = [], 0
    for i in range(phases):
        m = k >> i
        cum += budget // phases // m
        out += [cum] * (m if i == phases - 1 else m // 2)
    return np.array(out[::-1], np.int64)


def backup(own, value, std, visits, child_visits, child_values, child_stds, dtype=torch.float64):
    """A node's backed-up value and std: the mean of its returns, ``own``
    of them its own evaluation (``value``, ``std``) and the others those of
    its children, each child's mean value negated and both discounted once.
    [K] and [K, C] arrays; computed in ``dtype``."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(dtype)  # noqa: E731
    d = t(float(DISCOUNT))
    cn = t(child_visits)
    v = (t(own) * t(value) - d * (cn * t(child_values)).sum(-1)) / t(visits)
    s = (t(own) * t(std) + d * (cn * t(child_stds)).sum(-1)) / t(visits)
    return v.double().numpy(), s.double().numpy()
