"""The comparison that decides ``correct`` in a selfplay cell.

The harness hands over, as plain arrays and reference positions, what the
measured moves produced: a sample of the nodes of the last move's search
tree (every game's root and a seeded sample of the others) with their
positions, child slots, the logits the search stored and the evaluation of
the node still held by its unvisited children; each game's history since
its opening; and, for the last move, the target the host half recorded
(position, improved policy, UBE) and the action played.

Numbers compared:

* ``rules_errors``: positions that the reference rules do not give: a
  sampled node against the reference step from its parent's position, a
  root against the replay of its game, a recorded TPS against the root's;
* ``illegal_children``: child slots holding an action the reference does
  not allow;
* ``child_set_errors``: nodes whose child set is not every legal action
  (where they fit the slots) or whose truncation flag is wrong;
* ``logit_err`` and ``logit_rmse``: the widest gap, and the root mean
  square of the gaps, between a stored logit and the reference's, in units
  of the reference logits' root mean square;
* ``value_err``, ``value_rmse``, ``std_err``, ``std_rmse``: the same of a
  node's evaluation (its value, and the square root of its variance,
  which holds the SimHash lookup or the RND error) against the
  reference's;
* ``hash_errors`` (SimHash): nodes whose variance says seen where the
  reference's bucket is not in the seen-set, or the other way round;
* ``policy_err``: the widest gap between a recorded improved-policy
  probability and the one the search's own logits and visit statistics
  give (the host half's record);
* ``ube_err``: the recorded UBE target against the one the search's
  statistics give;
* ``action_errors``: weighted-random plies whose action is not the one the
  search's visit statistics and the benchmark's draw select;
* ``sims_errors``: searches that did not run their simulations: in
  selfplay every move of the window, each game's root children gaining the
  budget (and one more on a root carried from the last move, whose first
  simulation descends); in serve every ``go``, the root gaining its nodes;
* ``schedule_errors`` (selfplay): roots of the last move whose visits are
  not sequential halving's: the new visits on the ``k`` largest stored
  logits plus the move's Gumbel draw, in the schedule's counts (all valid
  children, each visited, where fewer than ``k``), none elsewhere but the
  carried root's one;
* ``visit_errors`` (selfplay): sampled nodes whose visits are not one
  (their own evaluation) plus their children's;
* ``backup_err``: the widest gap between a sampled node's backed-up value
  or std and the mean of its returns worked out from its stored evaluation
  and its children's visits, values and stds (nodes with a proven child
  or a proven value left out: the solver replaces their means).

The search's statistics are judged by these; the improved policy, the
UBE target and the actions then follow from them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import search, tak

F32 = np.float32


def legal_sets(positions: list) -> list:
    return [set(tak.legal_actions(p)) for p in positions]


def rules_errors(obs: dict) -> int:
    nodes, roots = obs["nodes"], obs["roots"]
    errors = 0
    for env, parent, action in zip(nodes["env"], nodes["parent_env"], nodes["action_in"]):
        if parent is not None and tak.step(parent, int(action)).key() != env.key():
            errors += 1
    n = obs["n"]
    for b, ri in enumerate(roots["root_index"]):
        if roots["history"][b] is None:  # the game's log restarted with this move
            continue
        root = nodes["env"][ri]
        p = tak.from_tps(n, roots["start_tps"][b])
        for a in roots["history"][b]:
            p = tak.step(p, int(a))
        if p.key() != root.key():
            errors += 1
        pending = roots["pending"][b]
        if pending is not None and pending["tps"] != tak.to_tps(root):
            errors += 1
    return errors


def _root(obs: dict, b: int, logits=None) -> dict:
    nodes, roots = obs["nodes"], obs["roots"]
    i = roots["root_index"][b]
    root = {k: nodes[k][i] for k in ("action", "visit", "flag", "ply", "value", "std", "node", "prob")}
    root.update(root_flag=int(roots["root_flag"][b]), root_ply=int(roots["root_ply"][b]),
                root_value=F32(roots["root_value"][b]))
    root["logit"] = nodes["logit"][i] if logits is None else logits
    return root


def program_outputs(obs: dict) -> dict:
    """What the program produced, in the form :func:`readings` compares."""
    nodes, roots = obs["nodes"], obs["roots"]
    k, c = nodes["action"].shape
    # A node's evaluation stays in its unvisited, unexpanded, unknown
    # children: their value is minus the node's and their std its own.
    fresh = (nodes["visit"] == 0) & (nodes["node"] < 0) & (nodes["flag"] == search.VALUE) & (nodes["action"] >= 0)
    has = fresh.any(1)
    first = np.argmax(fresh, axis=1)
    value = np.where(has, -nodes["value"][np.arange(k), first], np.nan)
    std = np.where(has, nodes["std"][np.arange(k), first], np.nan)
    policy = np.full((len(roots["root_index"]), c), np.nan, F32)
    for b, ri in enumerate(roots["root_index"]):
        pending = roots["pending"][b]
        if pending is None:
            continue
        probs = dict(pending["policy"])
        for j, a in enumerate(nodes["action"][ri]):
            if a >= 0:
                policy[b, j] = probs.get(int(a), np.nan)
    return {"logit": nodes["logit"], "value": value, "std": std, "has": has, "policy": policy,
            "ube": np.array([np.nan if p is None else p["ube"] for p in roots["pending"]], F32),
            "action": np.asarray(roots["action"]), "in_value": nodes["in_value"], "in_std": nodes["in_std"]}


def backup_inputs(obs: dict) -> tuple:
    """(nodes whose backup is compared, the reference's backup arguments):
    sampled non-root nodes with a stored evaluation, no proven value and
    no proven child; ``own`` is the visits that ended at the node."""
    nodes = obs["nodes"]
    stored = program_outputs(obs)
    valid = nodes["action"] >= 0
    child_n = np.where(valid, nodes["visit"], 0).astype(np.int64)
    own = nodes["in_visit"].astype(np.int64) - child_n.sum(1)
    known_child = (valid & (nodes["flag"] != search.VALUE)).any(1)
    ok = (~nodes["is_root"] & stored["has"] & (nodes["in_flag"] == search.VALUE) & ~known_child
          & (nodes["in_visit"] > 0))
    cv = np.where(valid, nodes["value"], 0.0)
    cs = np.where(valid, nodes["std"], 0.0)
    args = (own[ok], stored["value"][ok], stored["std"][ok], nodes["in_visit"][ok], child_n[ok], cv[ok], cs[ok])
    return ok, args, own


def reference_outputs_in_place(obs: dict, other: dict) -> dict:
    """The program's outputs with another evaluator's put in its place
    (the control): its logits at the program's child slots, its value and
    std where the program's node kept them, the improved policy from its
    logits and the search's statistics, and the program's own actions and
    UBE targets (they follow from the statistics alone)."""
    nodes, roots = obs["nodes"], obs["roots"]
    acts = nodes["action"]
    logit = np.where(acts >= 0, np.take_along_axis(other["logits"], np.maximum(acts, 0), axis=1), 0.0).astype(F32)
    out = program_outputs(obs)
    out["logit"] = logit
    out["value"] = np.where(out["has"], other["value"], np.nan)
    out["std"] = np.where(out["has"], other["std"], np.nan)
    for b, ri in enumerate(roots["root_index"]):
        if roots["pending"][b] is not None:
            out["policy"][b] = search.improved_policy(_root(obs, b, logit[ri]), logit[ri], obs["visitations"])
    # The backup in bfloat16, the precision below the tree's float32.
    ok, args, _ = backup_inputs(obs)
    out["in_value"], out["in_std"] = out["in_value"].astype(np.float64), out["in_std"].astype(np.float64)
    out["in_value"][ok], out["in_std"][ok] = search.backup(*args, dtype=torch.bfloat16)
    return out


def schedule_errors(obs: dict) -> int:
    nodes, roots = obs["nodes"], obs["roots"]
    k, budget = obs["sampled_actions"], obs["budget"]
    want = search.halving_visits(k, budget)
    bad = 0
    for b, ri in enumerate(roots["root_index"]):
        valid = nodes["action"][ri] >= 0
        new = nodes["visit"][ri].astype(np.int64) - roots["pre_visit"][b]
        extra = int(roots["pre_expanded"][b])
        cand = search.gumbel_candidates(nodes["logit"][ri], roots["gumbel_root"][b], valid, k)
        if len(cand) == k:
            over = np.sort(new[cand])[::-1] - want
            rest = np.delete(new, cand)
            ok = (over >= 0).all() and (rest >= 0).all() and over.sum() + rest.sum() == extra
        else:
            ok = (new[~valid] == 0).all() and (new[valid] >= 1).all() and new.sum() == budget + extra
        bad += not ok
    return bad


def search_readings(obs: dict, out: dict) -> dict:
    """``sims_errors``, ``schedule_errors``, ``visit_errors`` and
    ``backup_err`` (see the module) of the outputs ``out``."""
    ok, args, own = backup_inputs(obs)
    value, std = search.backup(*args)
    gaps = np.concatenate([np.abs(out["in_value"][ok] - value), np.abs(out["in_std"][ok] - std)])
    values = {"sims_errors": obs["sims_errors"], "backup_err": float(gaps.max()) if gaps.size else 0.0,
              "_backup_nodes": int(ok.sum())}
    if obs.get("halving"):
        expanded = ~obs["nodes"]["is_root"]
        values.update(schedule_errors=schedule_errors(obs), visit_errors=int(np.sum(expanded & (own != 1))))
    return values


def readings(obs: dict, legal: list, ref: dict, out: dict) -> dict:
    """Every compared number (see the module) of the outputs ``out``
    against the reference's ``ref`` (``logits`` [K, A], ``value`` and
    ``std`` [K] at the sampled nodes)."""
    nodes, roots = obs["nodes"], obs["roots"]
    c = obs["C"]
    acts = nodes["action"]
    valid = acts >= 0
    ref_at = np.take_along_axis(ref["logits"], np.maximum(acts, 0), axis=1)
    rms = float(np.sqrt(np.mean(ref_at[valid].astype(np.float64) ** 2)))
    illegal, set_errors = 0, 0
    for i, allowed in enumerate(legal):
        kept = {int(a) for a in acts[i][valid[i]]}
        illegal += len(kept - allowed)
        over = len(allowed) > c
        if bool(nodes["incomplete"][i]) != over or (not over and kept != allowed) or (over and len(kept) != c):
            set_errors += 1
    dl = (out["logit"][valid] - ref_at[valid]).astype(np.float64)
    logit_err = float(np.max(np.abs(dl))) / rms
    logit_rmse = float(np.sqrt(np.mean(dl**2))) / rms
    has = out["has"]
    # Where float32 rounding could move a SimHash bucket, the reference's
    # std is the one of the two answers nearer the program's.
    ref_std = np.where(np.abs(out["std"] - ref["std_alt"]) < np.abs(out["std"] - ref["std"]), ref["std_alt"], ref["std"])
    dv = (out["value"][has] - ref["value"][has]).astype(np.float64)
    ds = (out["std"][has] - ref_std[has]).astype(np.float64)
    value_err = float(np.max(np.abs(dv))) if has.any() else 0.0
    std_err = float(np.max(np.abs(ds))) if has.any() else 0.0
    value_rmse = float(np.sqrt(np.mean(dv**2))) if has.any() else 0.0
    std_rmse = float(np.sqrt(np.mean(ds**2))) if has.any() else 0.0
    # Under SimHash an unseen position's variance is the clip's 4 (std 2);
    # a seen one's is exp(ube), which the heads keep well under it.
    unseen = np.abs(out["std"] - 2.0) < 1e-3
    wrong = np.where(unseen, ~ref["unseen_possible"], ~ref["seen_possible"])
    hash_errors = int(np.sum(has & wrong)) if obs["simhash"] else None

    policy_err, ube_err, action_errors, unchecked = 0.0, 0.0, 0, 0
    for b, ri in enumerate(roots["root_index"]):
        pending = roots["pending"][b]
        if pending is None:
            unchecked += 1
            continue
        root = _root(obs, b)
        want = search.improved_policy(root, out["logit"][ri], obs["visitations"])
        ok = valid[ri]
        policy_err = max(policy_err, float(np.max(np.abs(out["policy"][b][ok] - want[ok]))))
        ube_err = max(ube_err, abs(float(out["ube"][b]) - search.ube_target(root, obs["beta"])))
        if pending["ply"] < obs["weighted_random_plies"]:
            slot = search.weighted_random_slot(root, roots["gumbel_sample"][b])
            action_errors += int(root["action"][slot] != out["action"][b])
        else:
            unchecked += 1
    return {
        "rules_errors": obs.get("rules_errors", 0),
        "illegal_children": illegal,
        "child_set_errors": set_errors,
        "logit_err": logit_err,
        "logit_rmse": logit_rmse,
        "value_err": value_err,
        "value_rmse": value_rmse,
        "std_err": std_err,
        "std_rmse": std_rmse,
        **({} if hash_errors is None else {"hash_errors": hash_errors}),
        "policy_err": policy_err,
        "ube_err": ube_err,
        "action_errors": action_errors,
        **search_readings(obs, out),
        "_roots_unchecked": unchecked,
        "_nodes": len(legal),
        "_logit_rms": rms,
    }
