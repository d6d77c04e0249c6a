"""Dedicated tinue-avoidance miner (the reference benchmark's a2/a4/a6
categories, puzzle/src/main.rs:55-111).

Counterpart of ``takzero_tpu/tools/mine_avoidance.py``, host-only on the
port's oracle; it keeps JAX's order of checks (a4, then a6) and its calls.

make_puzzles screens avoidance only where its device prover or a verified
tinue's predecessor suggests one, and each screen pays the FULL max-depth
ladder (max_threat 5 survivor proofs) — the yield bottleneck.  This miner inverts the search: every decisive
oracle game hands us defender-to-move positions 2/4/6 plies before the
end — positions that demonstrably collapsed — and each is verified with a
DEPTH-MATCHED ladder, cheapest first:

* depth 2: all-but-one moves lose to mate-in-1 — per-move cost is a
  1-ply search, thousands of candidates/hour on one core;
* depth 4: threat depth 3; * depth 6: threat depth 5 (gated on demand).

The depth-matched ladders are GATES only: every hit is re-verified with
the full ``make_puzzles.verify_avoidance(.., {2, 4, 6}, ..)`` ladder
(max_threat 5) before writing, so mined rows carry exactly the same
invariant as make_puzzles' — the unique survivor is proven safe against
threat-5 tinue, not merely against the gate's shallower threat.  Writes
the reference schema to --out; merge into a combined DB with
tools/merge_puzzles.

    python -m takzero_torch.tools.mine_avoidance --out avoidance.db \
        --size 6 --games 100000 --target 20
"""

from __future__ import annotations

import argparse
import sqlite3
import time

import numpy as np

from ..tak import action_to_ptn, engine
from ..tak.oracle import Oracle, oracle_opening
from ..tak.tps import state_to_tps
from .make_puzzles import DISCARDS, Writer, create_schema, verify_avoidance


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="avoidance.db")
    parser.add_argument("--size", type=int, default=6)
    parser.add_argument("--half-komi", type=int, default=4)
    parser.add_argument("--games", type=int, default=100_000)
    parser.add_argument("--min-ply", type=int, default=14)
    parser.add_argument("--target", type=int, default=20)
    parser.add_argument("--budget2", type=int, default=50_000)
    parser.add_argument("--budget4", type=int, default=200_000)
    parser.add_argument("--budget6", type=int, default=500_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--time-limit", type=float, default=None)
    args = parser.parse_args(argv)

    eng = engine(args.size, half_komi=args.half_komi)
    orc = Oracle(args.size, args.half_komi, eng.reversible_limit)
    rng = np.random.default_rng(args.seed)
    budgets = {2: args.budget2, 4: args.budget4, 6: args.budget6}

    con = sqlite3.connect(args.out)
    create_schema(con)
    w = Writer(con, args.size, (), {2, 4, 6}, args.target)
    t0 = time.time()
    need_caps = args.size >= 5

    checked = 0
    for g in range(args.games):
        if w.done() or (
            args.time_limit and time.time() - t0 > args.time_limit
        ):
            break
        state = oracle_opening(orc, rng)
        _, actions, res = orc.random_playout(
            state, seed=int(rng.integers(1, 2**31)), max_plies=200
        )
        if res not in (0, 1):
            continue
        states = [state]
        for a in actions:
            states.append(orc.step(states[-1], int(a)))
        L = len(states) - 1  # states[L] terminal; L-1 was the winning move
        for off in (2, 4, 6):
            if args.time_limit and time.time() - t0 > args.time_limit:
                break  # a slow ladder must not overrun the limit by games
            i = L - off
            if i < 0:
                continue
            st = states[i]
            if int(st.to_move) == res or int(st.ply) < args.min_ply:
                continue  # want the defender (eventual loser) to move
            if need_caps and (np.asarray(st.tops) == 3).sum() < 2:
                continue
            tps = state_to_tps(args.size, st)
            if tps in w.seen_tps:
                continue
            # Full threat-1 status first (1-ply proofs, ~ms): the
            # survivor count both settles depth 2 outright and gates the
            # expensive threat-3/5 ladders — a position where many moves
            # already survive mate-in-1 is (almost) never the
            # one-survivor knife edge deeper, and the laddered calls'
            # two-survivor early exit hides the count we'd need.
            st1 = orc.avoidance_status(st, 1, budgets[2])
            checked += 1
            legal = st1 != -1
            s1 = int((st1 == -2).sum())
            losing1 = st1 >= 0

            def confirm(budget):
                # Full-strength verification (identical to make_puzzles):
                # max_threat 5 ladder, unique survivor proven safe vs
                # threat-5, all other moves' minimal losing depths exact.
                nonlocal checked
                checked += 1
                got = verify_avoidance(orc, st, {2, 4, 6}, budget)
                if got is not None and w.want("a", got[0]):
                    w.add(g, tps, action_to_ptn(args.size, got[1]),
                          "a", got[0])
                    return True
                return False

            if s1 == 0:
                continue  # already lost: no avoidance exists
            if s1 == 1:
                if (st1[legal] == -3).any():
                    DISCARDS["avoid_budget"] += 1
                    continue
                if not losing1.any():
                    continue  # sole legal move: forced, not a puzzle
                d = int(st1[losing1].max()) + 1
                if d == 2 and w.want("a", 2):
                    confirm(budgets[6])
                continue  # all-but-one lose in <=1: d is 2 regardless
            if w.want("a", 4) and s1 <= 6:
                got = verify_avoidance(orc, st, {4}, budgets[4])
                checked += 1
                if got is not None and confirm(budgets[6]):
                    continue
            if w.want("a", 6) and 2 <= s1 <= 4:
                # {6} already runs the max_threat-5 ladder: full strength.
                got = verify_avoidance(orc, st, {6}, budgets[6])
                checked += 1
                if got is not None:
                    w.add(g, tps, action_to_ptn(args.size, got[1]), "a", 6)
        if (g + 1) % 200 == 0:
            con.commit()
            disc = " ".join(f"{k}={v}" for k, v in DISCARDS.items())
            print(
                f"game {g + 1}: {w.summary()} ({checked} ladder calls,"
                f" discards {disc}, {time.time() - t0:.0f}s)",
                flush=True,
            )
    con.commit()
    con.close()
    print(f"done in {time.time() - t0:.0f}s: {w.summary()} -> {args.out}")


if __name__ == "__main__":
    main()
