"""Re-verify avoidance puzzles at full strength and prune failures.

Counterpart of ``takzero_tpu/tools/audit_avoidance.py``, host-only on the
port's oracle.

A database mined with shallower gates may hold avoidance rows proven only
against their gate's threat depth (a2 survivors vs mate-in-1, a4 vs
threat-3).  The miner full-verifies before writing; this tool retrofits
the same invariant onto an EXISTING database — every row
with ``tinue_avoidance_length`` is rebuilt from its TPS and pushed
through ``make_puzzles.verify_avoidance(.., {2, 4, 6}, ..)`` (max_threat
5: unique survivor proven safe vs threat-5, exact minimal losing depths
for every other move, two-survivor early exit, budget-exhaustion
discards).  Rows whose proof fails — or whose depth/solution changes —
are deleted (or reported with --dry-run).  Reference category semantics:
puzzle/src/main.rs:55-111.

    python -m takzero_torch.tools.audit_avoidance --db puzzles.db \
        [--budget 500000] [--dry-run]
"""

from __future__ import annotations

import argparse
import sqlite3
import time

from ..tak import action_to_ptn
from ..tak.oracle import Oracle
from ..tak.tps import tps_to_state
from .make_puzzles import verify_avoidance


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--db", required=True)
    parser.add_argument("--half-komi", type=int, default=4)
    parser.add_argument("--budget", type=int, default=500_000)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    con = sqlite3.connect(args.db)
    rows = con.execute(
        "SELECT p.rowid, g.size, p.tps, p.solution, p.tinue_avoidance_length"
        " FROM puzzles p JOIN games g ON g.id = p.game_id"
        " WHERE p.tinue_avoidance_length IS NOT NULL"
    ).fetchall()
    oracles: dict[int, Oracle] = {}
    kept = relabeled = dropped = 0
    t0 = time.time()
    for i, (rowid, size, tps, sol, depth) in enumerate(rows):
        orc = oracles.setdefault(size, Oracle(size, args.half_komi))
        got = verify_avoidance(orc, tps_to_state(size, tps), {2, 4, 6},
                               args.budget)
        if got is None:
            dropped += 1
            print(f"[{i + 1}/{len(rows)}] DROP a{depth} rowid={rowid}"
                  f" (no full-strength proof) tps={tps}", flush=True)
            if not args.dry_run:
                con.execute("DELETE FROM puzzles WHERE rowid = ?", (rowid,))
                con.commit()
            continue
        new_depth, new_sol = got[0], action_to_ptn(size, got[1])
        if (new_depth, new_sol) != (depth, sol):
            relabeled += 1
            print(f"[{i + 1}/{len(rows)}] RELABEL rowid={rowid}"
                  f" a{depth}/{sol} -> a{new_depth}/{new_sol}", flush=True)
            if not args.dry_run:
                con.execute(
                    "UPDATE puzzles SET tinue_avoidance_length = ?,"
                    " solution = ? WHERE rowid = ?",
                    (new_depth, new_sol, rowid),
                )
                con.commit()
        else:
            kept += 1
            print(f"[{i + 1}/{len(rows)}] ok a{depth} rowid={rowid}"
                  f" ({time.time() - t0:.0f}s)", flush=True)
    con.commit()
    con.close()
    print(f"audited {len(rows)}: {kept} kept, {relabeled} relabeled,"
          f" {dropped} dropped in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
