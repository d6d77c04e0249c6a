"""The port's puzzle tools (``takzero_torch/tools/{make_puzzles,
mine_avoidance,audit_avoidance,merge_puzzles}.py``) against JAX's, at 3x3
with half-komi 0 on the CPU.

JAX's prover runs its search under ``TAKZERO_TOPK=exact_ref`` (the
contract of kernel A, as ``tests/test_torch_search.py`` runs it): off the
TPU its default is ``lax.top_k``, whose child-slot order differs.  With the
dummy evaluator every logit ties, so the trees must agree exactly.
"""

import re
import sqlite3

import numpy as np
import pytest
import torch

from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak.oracle import Oracle as JaxOracle
from takzero_tpu.tools import audit_avoidance as jax_audit
from takzero_tpu.tools import make_puzzles as jax_mp
from takzero_tpu.tools import merge_puzzles as jax_merge
from takzero_tpu.tools import mine_avoidance as jax_mine
from takzero_torch.tak import engine
from takzero_torch.tak.oracle import Oracle
from takzero_torch.tools import audit_avoidance, merge_puzzles, mine_avoidance
from takzero_torch.tools import make_puzzles as mp

from torch_parity import assert_state_equal

torch.set_num_threads(2)

# tests/test_make_puzzles.py's arguments.
MAKE_ARGS = ["--size", "3", "--half-komi", "0", "--games", "10", "--min-ply", "4", "--endgame-window", "8",
             "--budget", "256", "--batch", "16", "--deep-budget", "0", "--max-children", "48",
             "--tinue-depths", "1,3", "--avoidance-depths", "2", "--seed", "5"]
MINE_ARGS = ["--size", "3", "--half-komi", "0", "--games", "120", "--min-ply", "4", "--target", "3"]


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _candidates():
    args = dict(games=10, min_ply=4, need_caps=False, endgame_window=8)
    ours = mp.candidate_positions(engine(3), rng=np.random.default_rng(5), **args)
    theirs = jax_mp.candidate_positions(jax_engine(3), rng=np.random.default_rng(5), **args)
    return ours, theirs


def test_candidate_positions_match_jax():
    ours, theirs = _candidates()
    assert len(ours) == len(theirs) > 16
    for (s, g, states, i), (js, jg, jstates, ji) in zip(ours, theirs):
        assert (g, i, len(states)) == (jg, ji, len(jstates))
        assert_state_equal(s, js, f"game {g} ply index {i}")


def _rows(db, table):
    order = "id" if table == "games" else "rowid"
    return sqlite3.connect(db).execute(f"SELECT * FROM {table} ORDER BY {order}").fetchall()


def test_solved_batch_and_verifiers_match_jax():
    """One prover batch (budget 64, batch 8, C = 48): the root flags and the
    root's child actions and flags equal JAX's; so do the extracted lanes
    and the host verifiers' answers on every lane."""
    ours, theirs = _candidates()
    eng, jeng = engine(3), jax_engine(3)
    tree = mp.make_solver(eng, 64, 8, 48, "cpu")([c[0] for c in ours[:8]])
    jtree = jax_mp.make_solver(jeng, 64, 8, 48)([c[0] for c in theirs[:8]])
    np.testing.assert_array_equal(tree.root_flag.numpy(), np.asarray(jtree.root_flag))
    np.testing.assert_array_equal(tree.child_action[:, 0].numpy(), np.asarray(jtree.child_action[:, 0]))
    np.testing.assert_array_equal(tree.child_flag[:, 0].numpy(), np.asarray(jtree.child_flag[:, 0]))
    lanes = mp.extract_candidates(tree)
    assert lanes == jax_mp.extract_candidates(jtree)
    assert lanes[0], "some lane proven a win at 3x3"
    orc, jorc = Oracle(3, 0), JaxOracle(3, 0)
    for (s, *_), (js, *_) in zip(ours[:8], theirs[:8]):
        assert mp.verify_tinue(orc, s, 3, 100_000) == jax_mp.verify_tinue(jorc, js, 3, 100_000)
        assert mp.verify_avoidance(orc, s, {2, 4}, 100_000) == jax_mp.verify_avoidance(jorc, js, {2, 4}, 100_000)


def _strip_times(text: str) -> str:
    """The output without its seconds and its database path."""
    return re.sub(r"-> \S+", "-> DB", re.sub(r"\b\d+s\b", "Ns", text))


def test_make_puzzles_main_matches_jax(tmp_path, capsys):
    mp.main(["--out", str(tmp_path / "port.db"), *MAKE_ARGS, "--device", "cpu"])
    ours = capsys.readouterr().out
    jax_mp.main(["--out", str(tmp_path / "jax.db"), *MAKE_ARGS])
    theirs = capsys.readouterr().out
    for table in ("games", "puzzles"):
        assert _rows(tmp_path / "port.db", table) == _rows(tmp_path / "jax.db", table)
    assert any(r[3] == 1 for r in _rows(tmp_path / "port.db", "puzzles"))
    assert _strip_times(ours) == _strip_times(theirs)


def test_mine_and_audit_avoidance_match_jax(tmp_path, capsys):
    mine_avoidance.main(["--out", str(tmp_path / "port.db"), *MINE_ARGS])
    ours = capsys.readouterr().out
    jax_mine.main(["--out", str(tmp_path / "jax.db"), *MINE_ARGS])
    theirs = capsys.readouterr().out
    rows = _rows(tmp_path / "port.db", "puzzles")
    assert rows == _rows(tmp_path / "jax.db", "puzzles")
    assert {r[4] for r in rows} == {2, 4, 6}
    assert _strip_times(ours) == _strip_times(theirs)
    # A row whose label is wrong: both audits report it, relabel it alike.
    con = sqlite3.connect(tmp_path / "port.db")
    con.execute("UPDATE puzzles SET tinue_avoidance_length = 4 WHERE tinue_avoidance_length = 2")
    con.commit()
    con.close()
    args = ["--half-komi", "0", "--budget", "100000"]
    audit_avoidance.main(["--db", str(tmp_path / "port.db"), *args, "--dry-run"])
    ours = capsys.readouterr().out
    jax_audit.main(["--db", str(tmp_path / "port.db"), *args, "--dry-run"])
    assert _strip_times(ours) == _strip_times(capsys.readouterr().out)
    assert "RELABEL" in ours and "a4/" in ours
    (tmp_path / "copy.db").write_bytes((tmp_path / "port.db").read_bytes())
    audit_avoidance.main(["--db", str(tmp_path / "port.db"), *args])
    jax_audit.main(["--db", str(tmp_path / "copy.db"), *args])
    assert _rows(tmp_path / "port.db", "puzzles") == _rows(tmp_path / "copy.db", "puzzles") == rows


def test_merge_puzzles_matches_jax(tmp_path):
    small = ["--size", "3", "--half-komi", "0", "--games", "4", "--min-ply", "4", "--budget", "64",
             "--batch", "16", "--deep-budget", "0", "--max-children", "48", "--tinue-depths", "1,3",
             "--avoidance-depths", "2", "--seed", "1", "--device", "cpu"]
    mp.main(["--out", str(tmp_path / "a.db"), *small])
    mine_avoidance.main(["--out", str(tmp_path / "b.db"), *MINE_ARGS])
    srcs = [str(tmp_path / n) for n in ("a.db", "b.db", "a.db")]  # the second a.db: every row a duplicate
    got = merge_puzzles.merge(str(tmp_path / "port.db"), srcs)
    want = jax_merge.merge(str(tmp_path / "jax.db"), srcs)
    assert got == want and got["added"] > 0 and got["skipped_dup"] >= len(_rows(tmp_path / "a.db", "puzzles"))
    for table in ("games", "puzzles"):
        assert _rows(tmp_path / "port.db", table) == _rows(tmp_path / "jax.db", table)
