"""The port's offline tools (``takzero_torch/tools/``) against JAX's:
the host-only tools' outputs byte for byte, and the Elo-curve pipeline end
to end on the CPU over a tiny3 co-scheduled run, with the one deliberate
difference: a directed match logged twice counts once.  The reuse A/B has
its own file (``tests/test_torch_reuse_ab.py``: JAX's compiles take most of
a minute).
"""

import json

import torch

from takzero_tpu.tools import action_space as jax_action_space
from takzero_tpu.tools import analyze_search as jax_analyze
from takzero_tpu.tools import concat_out as jax_concat
from takzero_tpu.tools import elo as jax_elo
from takzero_tpu.tools import logs as jax_logs
from takzero_tpu.tools import match_results as jax_match
from takzero_tpu.tools import openings as jax_openings
from takzero_torch.drivers import coscheduled
from takzero_torch.tools import action_space, analyze_search, concat_out, elo, elo_curve, logs, match_results
from takzero_torch.tools import openings

torch.set_num_threads(2)

EVAL_LOG = (
    "runs/run_a/err\n"
    "INFO:evaluation:model_0000000.ckpt vs. model_0000016.ckpt: Evaluation { wins: 3, losses: 1, draws: 0 } 75.0%\n"
    "noise line\n"
    "INFO:evaluation:model_0000016.ckpt vs. model_0000000.ckpt: Evaluation { wins: 1, losses: 2, draws: 1 } 25.0%\n"
    "net_12.ot vs. net_40.ot: Evaluation { wins: 5, losses: 5, draws: 2 }\n"
    "INFO:evaluation:model_0000016.ckpt vs. model_0000032.ckpt: Evaluation { wins: 0, losses: 4, draws: 0 } 0.0%\n"
)


def _both(capsys, ours, theirs, *argv):
    ours(list(argv))
    a = capsys.readouterr().out
    theirs(list(argv))
    return a, capsys.readouterr().out


def test_match_results_and_elo_main(tmp_path, capsys):
    for rename in (None, "run-a"):
        assert match_results.scrape(EVAL_LOG, rename) == jax_match.scrape(EVAL_LOG, rename)
    (tmp_path / "eval-1.err").write_text(EVAL_LOG)
    (tmp_path / "eval-2.err").write_text(EVAL_LOG.split("\n", 1)[1])
    a, b = _both(capsys, match_results.main, jax_match.main, str(tmp_path), "--out", str(tmp_path / "m.csv"))
    assert a == b and "4 results" in a
    csv = (tmp_path / "m.csv").read_text()
    assert len(csv.splitlines()) == 8
    a, b = _both(capsys, elo.main, jax_elo.main, str(tmp_path / "m.csv"))
    assert a == b and len(a.splitlines()) == 8  # a_0, a_16, a_32, model_0, model_16, model_32, net_12, net_40


def test_logs(tmp_path, capsys):
    text = "".join(f"step {s}: loss={1 + s / 7:.4f} policy={s / 9:.4f} value=0.{s}5 ube=1.{s}\n" for s in range(6))
    assert logs.scrape_log(text) == jax_logs.scrape_log(text) and len(logs.scrape_log(text)) == 6
    (tmp_path / "learn.log").write_text("noise\n" + text)
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps({"step": s, "loss": s / 3, "loss_rnd": s}) + "\n" for s in range(5)) + "\n")
    for src in ("learn.log", "metrics.jsonl"):
        assert logs.load_metrics(tmp_path / src) == jax_logs.load_metrics(tmp_path / src)
        logs.main([str(tmp_path / src), "--out-csv", str(tmp_path / "x.csv")])
        a = capsys.readouterr().out
        jax_logs.main([str(tmp_path / src), "--out-csv", str(tmp_path / "y.csv")])
        assert a == capsys.readouterr().out and (tmp_path / "x.csv").read_text() == (tmp_path / "y.csv").read_text()
    assert logs.read_metrics_jsonl(metrics) == jax_logs.read_metrics_jsonl(metrics)


def test_action_space(capsys):
    for n in range(3, 9):
        assert (action_space.placements(n), action_space.spreads(n), action_space.total(n)) == (
            jax_action_space.placements(n), jax_action_space.spreads(n), jax_action_space.total(n))
    a, b = _both(capsys, action_space.main, jax_action_space.main, "--max-n", "8")
    assert a == b and len(a.splitlines()) == 7


def test_openings(tmp_path, capsys):
    books = openings.generate_openings(3, 0, 2)
    assert books == jax_openings.generate_openings(3, 0, 2) and len(books) == 12
    assert openings.generate_openings(4, 4, 2) == jax_openings.generate_openings(4, 4, 2)
    a, b = _both(capsys, openings.main, jax_openings.main, "--size", "4", "--depth", "2")
    assert a == b


def test_analyze_search_and_concat_out(tmp_path, capsys):
    lines = ["a1:10:0.25:0.1:1.5,b2:3:Win(3):0.0:0.2,c3:0:Loss(2):0.3:-1.0\n",
             "a1:1:Draw(5):0.2:0.0,b1:7:-0.5:0.05:2.0\n", "\n"]
    dump = tmp_path / "dump.txt"
    dump.write_text("".join(lines))
    assert analyze_search.load(dump) == jax_analyze.load(dump)
    assert analyze_search.analyze(analyze_search.load(dump), 0.3) == jax_analyze.analyze(jax_analyze.load(dump), 0.3)
    a, b = _both(capsys, analyze_search.main, jax_analyze.main, str(dump))
    assert a == b and "roots: 2" in a
    early, later = tmp_path / "early", tmp_path / "later"
    early.mkdir()
    later.mkdir()
    (early / "x.err").write_text("one\n")
    (early / "y.out").write_text("two\n")
    (later / "x.err").write_text("three\n")
    assert concat_out.concat_dirs(early, later, tmp_path / "o1") == jax_concat.concat_dirs(early, later, tmp_path / "o2")
    for name in ("x.err", "y.out"):
        assert (tmp_path / "o1" / name).read_text() == (tmp_path / "o2" / name).read_text()
    assert (tmp_path / "o1" / "x.err").read_text() == "one\nthree\n"


def test_elo_curve_pipeline(tmp_path, monkeypatch):
    """tests/test_elo_curve.py's run, on the port and the CPU: a tiny3
    co-scheduled run with numbered checkpoints, two pairs played by the
    port's evaluation driver in subprocesses, the fit, and a re-fit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the subprocesses' torch threads
    coscheduled.main([
        "--directory", str(tmp_path), "--net", "tiny3", "--seed", "3", "--device", "cpu",
        "--batch", "4", "--budget", "16", "--sampled", "4", "--batch-size", "8", "--steps-per-move", "2",
        "--max-moves", "40", "--steps-per-checkpoint", "16",
    ])
    args = ["--directory", str(tmp_path), "--net", "tiny3", "--device", "cpu"]
    rows = elo_curve.main(args + ["--rounds", "2", "--games", "2", "--budget", "16", "--sampled", "4",
                                  "--seed", "5"])
    data = json.loads((tmp_path / "elo_curve.json").read_text())
    assert data["curve"] == rows and data["matches"] == 4
    assert [r["steps"] for r in rows] == [0, 16, 32]
    assert all(abs(r["elo"]) < 5000 and r["stderr"] > 0 for r in rows)
    assert len((tmp_path / "match_results.csv").read_text().splitlines()) == 4
    assert elo_curve.main(args + ["--skip-matches"]) == rows
    # Resume: both pairs are logged, so a third round plays the next pair only.
    assert len(elo_curve.played_pairs(tmp_path)) == 4


def test_elo_curve_keeps_the_last_line_of_a_directed_pair(tmp_path):
    """A directed match logged twice (a retried pair) is one row of the
    CSV and one match of the fit; JAX's scrape counts it twice."""
    lines = [x for x in EVAL_LOG.splitlines(keepends=True) if x.startswith("INFO:")]
    redo = lines[0].replace("wins: 3, losses: 1", "wins: 2, losses: 2")
    (tmp_path / "eval_curve.log").write_text("".join(lines) + redo)
    assert elo_curve.match_lines(tmp_path) == lines[1:] + [redo]
    assert elo_curve.played_pairs(tmp_path) == {
        ("model_0000000.ckpt", "model_0000016.ckpt"), ("model_0000016.ckpt", "model_0000000.ckpt"),
        ("model_0000016.ckpt", "model_0000032.ckpt")}
    elo_curve.main(["--directory", str(tmp_path), "--skip-matches"])
    csv = (tmp_path / "match_results.csv").read_text().splitlines()
    assert len(csv) == 3 and "model, 0, model, 16, 2, 2, 0" in csv and "model, 0, model, 16, 3, 1, 0" not in csv
    assert len(jax_match.scrape((tmp_path / "eval_curve.log").read_text())) == 4
    assert json.loads((tmp_path / "elo_curve.json").read_text())["matches"] == 3
