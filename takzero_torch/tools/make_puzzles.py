"""Generate a tinue puzzle database with the reference's schema.

Counterpart of ``takzero_tpu/tools/make_puzzles.py``.  The reference
consumes an externally-built SQLite DB of 6x6 tinue (win-in-N) and
tinue-avoidance puzzles (puzzle/src/main.rs:132-166); this tool builds one
in three stages:

1. CANDIDATES: random games played by the C++ oracle; positions from the
   last ``--endgame-window`` plies of decisive games (where forced wins
   concentrate), with the reference's both-capstones-placed filter.
2. DEVICE PROVER: the batched exact solver (dummy-agent MCTS — pure
   win/loss/draw proving, one ``simulate`` then ``simulate_batch`` 64 at a
   time on ``--device``) flags roots proven Win (tinue candidates) and
   unproven roots with all-but-one stored children proven Win (avoidance
   candidates).  A second pass re-solves unproven candidates at
   ``--deep-budget`` to reach depth-7/9 proofs.
3. EXACT VERIFICATION (``cpp/tak_solver.cpp``): every candidate is
   re-solved full-width on the host — iterative deepening gives the
   MINIMAL tinue depth (the device prover's proof distance is only an
   upper bound), the stored solution is validated, and avoidance
   positions are checked over ALL legal moves (the device tree may
   truncate children, which is exactly where its "all-but-one lose"
   evidence is unsound).  Each verified tinue's predecessor position is
   additionally screened as an avoidance candidate.

Schema matches the queries in drivers/puzzle.py: ``games(id, size)`` and
``puzzles(game_id, tps, solution, tinue_length, tinue_avoidance_length,
tiltak_2komi_eval, tiltak_2komi_second_move_eval)`` (eval columns written
as 0.0 — they are external-engine filters in the reference data).

    python -m takzero_torch.tools.make_puzzles --out puzzles.db --size 6 \
        --games 256 --budget 8192 --target 50 [--device cuda]
"""

from __future__ import annotations

import argparse
import sqlite3
import time

import numpy as np
import torch

from ..device import resolve_device
from ..search import eval as ev
from ..search.agents import dummy_evaluator
from ..search.core import make_kernels
from ..search.tree import init_tree
from ..tak import action_to_ptn, engine
from ..tak.oracle import Oracle, oracle_opening
from ..tak.tps import state_to_tps
from ..train.data import stack_states

SIM_CHUNK = 64  # simulations per simulate_batch call
SCHEMA = (
    "CREATE TABLE IF NOT EXISTS games (id INTEGER PRIMARY KEY, size INTEGER)",
    """CREATE TABLE IF NOT EXISTS puzzles (
            game_id INTEGER, tps TEXT, solution TEXT,
            tinue_length INTEGER, tinue_avoidance_length INTEGER,
            tiltak_2komi_eval REAL, tiltak_2komi_second_move_eval REAL)""",
)


def create_schema(con) -> None:
    for stmt in SCHEMA:
        con.execute(stmt)


def candidate_positions(eng, games: int, min_ply: int, rng, need_caps: bool, endgame_window: int = 0):
    """[(state, game_id, game_states, i)] candidates from oracle games.

    Per game, the draws are ``oracle_opening`` then ``rng.integers(1,
    2**31)`` for the playout seed, as in JAX.  With ``endgame_window`` > 0,
    only decisive games contribute, and only their last `window` positions
    — forced wins live near the end.  Each candidate carries its full game
    history so verified tinues can be mined backward (the position one ply
    earlier seeds the avoidance screen, the one two plies earlier is the
    next deeper tinue candidate).
    """
    orc = Oracle(eng.n, eng.half_komi, eng.reversible_limit)
    out = []
    for g in range(games):
        state = oracle_opening(orc, rng)
        _, actions, res = orc.random_playout(state, seed=int(rng.integers(1, 2**31)), max_plies=200)
        if endgame_window and res not in (0, 1):
            continue
        states = [state]
        cur = state
        for a in actions:
            cur = orc.step(cur, int(a))
            states.append(cur)
        lo = max(0, len(states) - 1 - endgame_window) if endgame_window else 0
        for i in range(lo, len(states) - 1):  # last entry is terminal
            cur = states[i]
            if int(cur.ply) < min_ply:
                continue
            if need_caps and int((cur.tops == 3).sum()) < 2:
                continue
            out.append((cur, g, states, i))
    return out


def make_solver(eng, budget: int, batch: int, max_children: int, device):
    """``solve(states) -> tree``: the exact solver (uniform-policy search)
    over ``batch`` lanes on ``device``, padded with copies of the last
    state; one ``simulate`` then ``budget // 64`` calls of
    ``simulate_batch(tree, 0, 64)``, so kernel A launches ``budget + 1``
    times a solve (one per simulation, in ``apply_eval``)."""
    simulate, simulate_batch = make_kernels(eng, dummy_evaluator(eng), max_depth=24)
    device = torch.device(device)

    def solve(states):
        states = list(states)
        states = states + [states[-1]] * (batch - len(states))
        envs = stack_states(states).map(lambda x: x.to(device))
        tree = init_tree(eng, envs, budget + 8, max_children)
        zeros = torch.zeros((batch,), dtype=torch.float32, device=device)
        tree = simulate(tree, zeros)
        for _ in range(budget // SIM_CHUNK):
            tree = simulate_batch(tree, zeros, SIM_CHUNK)
        return tree

    return solve


def extract_candidates(tree):
    """(win_lanes, avoid_lanes) from a solved batch.

    win lanes: root proven Win — exact depth assigned later by the host
    verifier (the device proof's ply is an upper bound only).
    avoid lanes: root unproven, >= 1 stored child proven Win and exactly
    one stored child not — subject to full-width host verification.
    """
    root_flag = tree.root_flag.cpu().numpy()
    ca = tree.child_action[:, 0, :].cpu().numpy()
    cf = tree.child_flag[:, 0, :].cpu().numpy()
    win_lanes, avoid_lanes = [], []
    for b in range(root_flag.shape[0]):
        valid = ca[b] >= 0
        if not valid.any():
            continue
        if root_flag[b] == ev.WIN:
            win_lanes.append(b)
        elif root_flag[b] == ev.VALUE:
            losing = valid & (cf[b] == ev.WIN)
            if losing.sum() >= 1 and (valid & ~losing).sum() == 1:
                avoid_lanes.append(b)
    return win_lanes, avoid_lanes


class Writer:
    """Collects verified puzzles; one game row per contributing game."""

    def __init__(self, con, size: int, tinue_depths, avoidance_depths, target: int):
        self.con = con
        self.size = size
        self.counts = {("t", d): 0 for d in sorted(tinue_depths)}
        self.counts.update({("a", d): 0 for d in sorted(avoidance_depths)})
        self.target = target
        self.seen_games = set()
        self.seen_tps = set()
        self.game_base = con.execute("SELECT COALESCE(MAX(id) + 1, 0) FROM games").fetchone()[0]
        for (kind, depth), have in self.existing().items():
            if (kind, depth) in self.counts:
                self.counts[(kind, depth)] = have

    def existing(self):
        rows = self.con.execute(
            "SELECT tinue_length, tinue_avoidance_length, COUNT(*) FROM"
            " puzzles JOIN games ON puzzles.game_id = games.id WHERE"
            " games.size = ? GROUP BY 1, 2", (self.size,)
        ).fetchall()
        out = {}
        for tl, al, cnt in rows:
            out[("t", tl) if tl is not None else ("a", al)] = cnt
        for (tps,) in self.con.execute("SELECT tps FROM puzzles"):
            self.seen_tps.add(tps)
        return out

    def want(self, kind: str, depth: int) -> bool:
        c = self.counts.get((kind, depth))
        return c is not None and c < self.target

    def done(self) -> bool:
        return all(c >= self.target for c in self.counts.values())

    def add(self, game_id: int, tps: str, solution: str, kind: str, depth: int) -> bool:
        if tps in self.seen_tps or not self.want(kind, depth):
            return False
        self.seen_tps.add(tps)
        gid = game_id + self.game_base
        if gid not in self.seen_games:
            self.seen_games.add(gid)
            self.con.execute("INSERT INTO games VALUES (?, ?)", (gid, self.size))
        self.con.execute(
            "INSERT INTO puzzles VALUES (?, ?, ?, ?, ?, 0.0, 0.0)",
            (gid, tps, solution, depth if kind == "t" else None, depth if kind == "a" else None),
        )
        self.counts[(kind, depth)] += 1
        return True

    def summary(self) -> str:
        return " ".join(f"{'tinue' if k == 't' else 'avoid'}{d}={c}" for (k, d), c in sorted(self.counts.items()))


# Per-run counts of candidates discarded because the verifier's node
# budget was exhausted (labels stay exact — exhausted searches discard
# rather than mislabel — but yield silently tracks --verify-nodes).
DISCARDS = {"tinue_budget": 0, "witness_budget": 0, "avoid_budget": 0}


def verify_tinue(orc, state, max_depth: int, node_budget: int):
    """(exact_depth, solution_action) or None — full-width host proof.

    ``tinue_depth`` deepens over odd depths, so d is MINIMAL; the witness
    move is any a with the opponent lost within d-1 (d=1: an immediate
    terminal win).  A cheap pass at node_budget/64 usually finds it; only
    the moves it left unknown are retried at the full budget.
    """
    d = orc.tinue_depth(state, max_depth, node_budget)
    if d <= 0:
        if d < 0:
            DISCARDS["tinue_budget"] += 1
        return None
    retry = []
    for a in np.nonzero(orc.legal_mask(state))[0]:
        nxt = orc.step(state, int(a))
        if d == 1:
            if orc.result(nxt) == int(state.to_move):
                return d, int(a)
        elif orc.result(nxt) == -1:
            r = orc.loses_within(nxt, d - 1, max(node_budget // 64, 1000))
            if r == 1:
                return d, int(a)
            if r < 0:
                retry.append((int(a), nxt))
    for a, nxt in retry:
        if orc.loses_within(nxt, d - 1, node_budget) == 1:
            return d, a
    DISCARDS["witness_budget"] += 1
    return None  # proof existed but no witness within budget: discard


def verify_avoidance(orc, state, depths, node_budget: int):
    """(depth, solution_action) or None — checks ALL legal moves.

    Laddered: moves solve at node_budget/64 first, unknowns retry at the
    full budget, and the C++ side bails once TWO survivors are proven.
    The survivor count is checked BEFORE the -3 budget test: after an
    early exit the remaining labels are stale by design."""
    max_threat = max(depths) - 1
    status = orc.avoidance_status_laddered(state, max_threat, max(node_budget // 64, 1000), node_budget)
    survivors = np.nonzero(status == -2)[0]
    if len(survivors) != 1:
        return None  # zero or multiple proven escapes: not a puzzle
    legal = status != -1
    if (status[legal] == -3).any():
        DISCARDS["avoid_budget"] += 1
        return None  # some move unknown within budget: not provable
    losing = status >= 0
    if losing.sum() != legal.sum() - 1:
        return None
    d = int(status[losing].max()) + 1
    return (d, int(survivors[0])) if d in depths else None


def main(argv=None) -> dict:
    """Build or extend the database; returns the run's summary (solves,
    seconds, candidates, counts and discards)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="puzzles.db")
    parser.add_argument("--size", type=int, default=6)
    parser.add_argument("--half-komi", type=int, default=4)
    parser.add_argument("--games", type=int, default=256)
    parser.add_argument("--min-ply", type=int, default=14)
    parser.add_argument("--endgame-window", type=int, default=14,
                        help="use only the last N plies of decisive games (0: every position past --min-ply)")
    parser.add_argument("--budget", type=int, default=8192)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--deep-budget", type=int, default=32768,
                        help="second-pass budget for lanes the first pass left unproven (0 disables the pass)")
    parser.add_argument("--deep-batch", type=int, default=16)
    parser.add_argument("--max-children", type=int, default=128)
    parser.add_argument("--tinue-depths", default="3,5,7,9")
    parser.add_argument("--avoidance-depths", default="2,4,6")
    parser.add_argument("--target", type=int, default=50, help="stop once every category holds this many")
    parser.add_argument("--verify-nodes", type=int, default=500_000,
                        help="host verifier node budget per deepening iteration; exhausted searches discard the"
                        " candidate. Witness validation multiplies this by the branching factor (one"
                        " loses_within per legal move), so large budgets make a single candidate take minutes")
    parser.add_argument("--no-verify", action="store_true",
                        help="trust device proofs/depths (test scale only; depth labels become upper bounds and"
                        " truncated avoidance roots are NOT re-checked)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--time-limit", type=float, default=None, help="stop cleanly after this many seconds")
    parser.add_argument("--device", default="cuda", help="torch device of the prover (default cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    eng = engine(args.size, half_komi=args.half_komi)
    orc = Oracle(args.size, args.half_komi, eng.reversible_limit)
    rng = np.random.default_rng(args.seed)
    tinue_depths = {int(x) for x in args.tinue_depths.split(",") if x}
    avoidance_depths = {int(x) for x in args.avoidance_depths.split(",") if x}
    max_tinue = max(tinue_depths)

    con = sqlite3.connect(args.out)
    create_schema(con)
    w = Writer(con, args.size, tinue_depths, avoidance_depths, args.target)
    t_start = time.time()
    solves = 0

    def out_of_time():
        return args.time_limit is not None and time.time() - t_start > args.time_limit

    cands = candidate_positions(eng, args.games, args.min_ply, rng, need_caps=args.size >= 5,
                                endgame_window=args.endgame_window)
    rng.shuffle(cands)
    print(f"{len(cands)} candidate positions from {args.games} games")
    solve = make_solver(eng, args.budget, args.batch, args.max_children, dev)
    deep_solve = None
    if args.deep_budget:
        deep_solve = make_solver(eng, args.deep_budget, args.deep_batch, args.max_children, dev)

    def screen_avoidance(game_id, prev):
        """Avoidance screen one ply above a verified tinue."""
        if prev is None or not any(w.want("a", ad) for ad in avoidance_depths):
            return
        tps = state_to_tps(eng.n, prev)
        if tps in w.seen_tps:
            return
        got_a = verify_avoidance(orc, prev, avoidance_depths, args.verify_nodes)
        if got_a is not None:
            w.add(game_id, tps, action_to_ptn(eng.n, got_a[1]), "a", got_a[0])

    def verify_tinue_at(game_id, states, i):
        """Verify states[i] as a tinue; returns its exact depth or None.
        On success also screens states[i-1] for avoidance."""
        state = states[i]
        tps = state_to_tps(eng.n, state)
        if tps in w.seen_tps:
            return None
        got = verify_tinue(orc, state, max_tinue, args.verify_nodes)
        if got is None:
            return None
        d, sol = got
        if w.want("t", d):
            w.add(game_id, tps, action_to_ptn(eng.n, sol), "t", d)
        if i >= 1:
            screen_avoidance(game_id, states[i - 1])
        return d

    def verify_and_write(kind, lane_idx, chunk):
        """Host-verify one candidate lane and insert it if it fits.  A
        verified tinue is mined backward: the attacker's previous turn (two
        plies up) is verified as a deeper tinue, while the game stayed
        inside the forced win (at most 4 steps)."""
        state, game_id, states, i = chunk[lane_idx]
        if kind == "t":
            d = verify_tinue_at(game_id, states, i)
            walked = 0
            while d is not None and d < max_tinue and i >= 2 and walked < 4:
                i -= 2
                walked += 1
                d = verify_tinue_at(game_id, states, i)
        else:
            tps = state_to_tps(eng.n, state)
            if tps in w.seen_tps:
                return
            got = verify_avoidance(orc, state, avoidance_depths, args.verify_nodes)
            if got is not None:
                w.add(game_id, tps, action_to_ptn(eng.n, got[1]), "a", got[0])

    def device_write(tree, chunk, lanes_win, lanes_avoid):
        """--no-verify path: trust device proofs."""
        root_ply = tree.root_ply.cpu().numpy()
        ca = tree.child_action[:, 0, :].cpu().numpy()
        cf = tree.child_flag[:, 0, :].cpu().numpy()
        cp = tree.child_ply[:, 0, :].cpu().numpy()
        for b in lanes_win:
            state, game_id, _, _ = chunk[b]
            valid = ca[b] >= 0
            d = int(root_ply[b])
            sols = np.nonzero(valid & (cf[b] == ev.WIN) & (cp[b] == d - 1))[0]
            if d in tinue_depths and len(sols) and w.want("t", d):
                w.add(game_id, state_to_tps(eng.n, state), action_to_ptn(eng.n, int(ca[b][sols[0]])), "t", d)
        for b in lanes_avoid:
            state, game_id, _, _ = chunk[b]
            valid = ca[b] >= 0
            losing = valid & (cf[b] == ev.WIN)
            survivors = np.nonzero(valid & ~losing)[0]
            d = int(cp[b][losing].max()) + 1
            if d in avoidance_depths and w.want("a", d):
                w.add(game_id, state_to_tps(eng.n, state), action_to_ptn(eng.n, int(ca[b][survivors[0]])), "a", d)

    deep_later = []
    batch_no = 0
    for i in range(0, len(cands), args.batch):
        if w.done() or out_of_time():
            break
        chunk = cands[i : i + args.batch]
        tree = solve([s for s, _, _, _ in chunk])
        solves += 1
        lanes_win, lanes_avoid = extract_candidates(tree)
        lanes_win = [b for b in lanes_win if b < len(chunk)]
        lanes_avoid = [b for b in lanes_avoid if b < len(chunk)]
        if args.no_verify:
            device_write(tree, chunk, lanes_win, lanes_avoid)
        else:
            for b in lanes_win:
                verify_and_write("t", b, chunk)
            for b in lanes_avoid:
                verify_and_write("a", b, chunk)
            flagged = set(lanes_win) | set(lanes_avoid)
            deep_later.extend(c for b, c in enumerate(chunk) if b not in flagged)
        con.commit()
        batch_no += 1
        if batch_no % 5 == 0 or w.done():
            print(f"batch {batch_no}: {w.summary()}", flush=True)

    # Deep pass: the first pass proved nothing on these lanes; a larger
    # budget reaches depth-7/9 proof trees the short pass could not.
    if deep_solve is not None and not args.no_verify:
        rng.shuffle(deep_later)
        for i in range(0, len(deep_later), args.deep_batch):
            if w.done() or out_of_time():
                break
            chunk = deep_later[i : i + args.deep_batch]
            tree = deep_solve([s for s, _, _, _ in chunk])
            solves += 1
            lanes_win, lanes_avoid = extract_candidates(tree)
            for b in [b for b in lanes_win if b < len(chunk)]:
                verify_and_write("t", b, chunk)
            for b in [b for b in lanes_avoid if b < len(chunk)]:
                verify_and_write("a", b, chunk)
            con.commit()
            print(f"deep batch {i // args.deep_batch}: {w.summary()}", flush=True)

    con.commit()
    con.close()
    seconds = time.time() - t_start
    disc = " ".join(f"{k}={v}" for k, v in DISCARDS.items())
    print(f"budget-exhausted discards: {disc}")
    print(f"done in {seconds:.0f}s: {w.summary()} -> {args.out}")
    return {"candidates": len(cands), "solves": solves, "seconds": seconds, "summary": w.summary(),
            "discards": dict(DISCARDS)}


if __name__ == "__main__":
    main()
