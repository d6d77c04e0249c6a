"""Merge puzzle DBs (reference schema) into one, deduplicating by TPS.

The pipeline generates tinues (tools/make_puzzles, device prover
+ host verification) and avoidance (tools/mine_avoidance, defender-
collapse mining) in separate processes/DBs — SQLite's single-writer
locking makes concurrent accumulation into one file fragile.  This tool
folds any number of source DBs into --out, remapping game ids past the
destination's maximum and skipping positions already present.

The port's copy of ``takzero_tpu/tools/merge_puzzles.py`` (host code only).

    python -m takzero_torch.tools.merge_puzzles --out puzzles.db a.db b.db
"""

from __future__ import annotations

import argparse
import sqlite3


def merge(out_path: str, src_paths: list[str],
          default_size: int | None = None) -> dict:
    con = sqlite3.connect(out_path)
    con.execute(
        "CREATE TABLE IF NOT EXISTS games (id INTEGER PRIMARY KEY,"
        " size INTEGER)"
    )
    con.execute(
        """CREATE TABLE IF NOT EXISTS puzzles (
            game_id INTEGER, tps TEXT, solution TEXT,
            tinue_length INTEGER, tinue_avoidance_length INTEGER,
            tiltak_2komi_eval REAL, tiltak_2komi_second_move_eval REAL)"""
    )
    seen = {t for (t,) in con.execute("SELECT tps FROM puzzles")}
    added = skipped = 0
    for src in src_paths:
        s = sqlite3.connect(src)
        base = con.execute(
            "SELECT COALESCE(MAX(id) + 1, 0) FROM games"
        ).fetchone()[0]
        games = dict(s.execute("SELECT id, size FROM games"))
        used_games = set()
        for row in s.execute(
            "SELECT game_id, tps, solution, tinue_length,"
            " tinue_avoidance_length, tiltak_2komi_eval,"
            " tiltak_2komi_second_move_eval FROM puzzles"
        ):
            gid, tps = row[0], row[1]
            if tps in seen:
                skipped += 1
                continue
            size = games.get(gid, default_size)
            if size is None:
                # A NULL size would silently hide the row from every
                # consumer (drivers/puzzle.py and the reference both
                # filter on games.size = ?) — skip loudly instead.
                print(f"WARNING: {src} puzzle game_id={gid} has no games"
                      " row and no --size fallback; skipping")
                skipped += 1
                continue
            seen.add(tps)
            new_gid = base + gid
            if new_gid not in used_games:
                used_games.add(new_gid)
                con.execute(
                    "INSERT INTO games VALUES (?, ?)",
                    (new_gid, size),
                )
            con.execute(
                "INSERT INTO puzzles VALUES (?, ?, ?, ?, ?, ?, ?)",
                (new_gid,) + row[1:],
            )
            added += 1
        s.close()
    con.commit()
    counts = {}
    for tl, al, c in con.execute(
        "SELECT tinue_length, tinue_avoidance_length, COUNT(*) FROM"
        " puzzles GROUP BY 1, 2"
    ):
        counts[f"t{tl}" if tl is not None else f"a{al}"] = c
    con.close()
    return {"added": added, "skipped_dup": skipped, "counts": counts}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True)
    parser.add_argument("--size", type=int, default=None,
                        help="board size for puzzles whose source games"
                        " row is missing (otherwise skipped, warned)")
    parser.add_argument("sources", nargs="+")
    args = parser.parse_args(argv)
    print(merge(args.out, args.sources, args.size))


if __name__ == "__main__":
    main()
