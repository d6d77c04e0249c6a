"""Import hygiene and device defaults of the port.

``takzero_torch`` and ``chip_smoke.py`` import no JAX, no flax and nothing
of ``takzero_tpu`` (checked in a fresh interpreter, since this test
process has JAX loaded).  The entry points run on ``cuda`` unless the
caller asks for the CPU, and raise when CUDA is missing.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
import takzero_torch
names = [m.name for m in pkgutil.walk_packages(takzero_torch.__path__, "takzero_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "takzero_tpu"))
print(len(names), bad, " ".join(names))
sys.exit(1 if bad else 0)
"""

# The modules of the EEE experiments and the visualizers (PR 8).
EEE_AND_VISUALIZERS = [
    "takzero_torch.eee.harness", "takzero_torch.eee.rnd", "takzero_torch.eee.generalization",
    "takzero_torch.eee.ensemble", "takzero_torch.eee.seen_ratio", "takzero_torch.drivers.eee",
    "takzero_torch.drivers.graph", "takzero_torch.drivers.visualize_replay_buffer",
    "takzero_torch.drivers.visualize_search", "takzero_torch.tools.logs", "takzero_torch.tools.plots",
]

# The rules oracle and the offline tools.
ORACLE_AND_TOOLS = [
    "takzero_torch.ops._cpp_build", "takzero_torch.tak.oracle", "takzero_torch.tools.make_puzzles",
    "takzero_torch.tools.mine_avoidance", "takzero_torch.tools.audit_avoidance", "takzero_torch.tools.merge_puzzles",
    "takzero_torch.tools.openings", "takzero_torch.tools.match_results", "takzero_torch.tools.elo",
    "takzero_torch.tools.elo_curve", "takzero_torch.tools.reuse_ab", "takzero_torch.tools.action_space",
    "takzero_torch.tools.analyze_search", "takzero_torch.tools.concat_out", "takzero_torch.tools.anchor",
]


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 85, out.stdout  # every module of the port was imported
    names = out.stdout.split("] ", 1)[1].split()
    assert set(EEE_AND_VISUALIZERS) <= set(names)
    assert set(ORACLE_AND_TOOLS) <= set(names)


def test_entry_points_refuse_devices():
    """--devices is not ported: every driver of the serve path raises."""
    from takzero_torch.drivers import analysis, evaluation, puzzle, tei

    for main, argv in (
        (tei.main, []), (analysis.main, []), (evaluation.main, ["--model-path", "x"]),
        (puzzle.main, ["--model", "x", "--puzzle-db", "y"]),
    ):
        with pytest.raises(NotImplementedError, match="--devices"):
            main(argv + ["--net", "tiny3", "--device", "cpu", "--devices", "2"])


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    import numpy as np

    from takzero_torch import bench
    from takzero_torch.data.native_loader import make_batch_native
    from takzero_torch.drivers import learn, reanalyze, selfplay
    from takzero_torch.train.data import random_pretraining_targets
    from takzero_torch.device import resolve_device
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.models.network import NetConfig
    from takzero_torch.selfplay import SelfplayConfig, SelfplayEngine
    from takzero_torch.tak import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NetConfig(n=3, half_komi=0, filters=8, blocks=1, hash_bits=12)
    eng = engine(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        new_agent(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_net_evaluate(cfg, eng)
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfplayEngine(eng, SelfplayConfig(batch=2), make_net_evaluate(cfg, eng, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.setup(bench.BenchConfig(batch=2, budget=6, sampled=2, filters=8, blocks=1))
    # The learner: the driver without --device, its batches and its
    # pre-training games, and the trainable agent the driver builds.
    with pytest.raises(RuntimeError, match="CUDA"):
        learn.main(["--directory", str(tmp_path), "--net", "tiny3", "--no-wait", "--max-steps", "0"])
    assert not any(tmp_path.iterdir())
    # The actors: both drivers without --device.
    for actor in (selfplay, reanalyze):
        with pytest.raises(RuntimeError, match="CUDA"):
            actor.main(["--directory", str(tmp_path), "--net", "tiny3", "--max-steps", "1"])
        assert not any(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch_native(eng, "x,x,x/x,x,x/x,x,x 1 1;0;0;a1:1\n", np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        random_pretraining_targets(eng, 4, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        new_agent(cfg, seed=1)
    # The serve path: the TEI engine, the analysis REPL, the pit fighter,
    # the puzzle benchmark and the serve bench, each without --device.
    from takzero_torch import serve_bench
    from takzero_torch.drivers import analysis, evaluation, puzzle
    from takzero_torch.drivers.tei import TeiEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        TeiEngine("tiny3", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.main(["--net", "tiny3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation.main(["--model-path", str(tmp_path), "--net", "tiny3", "--rounds", "1"])
    db = tmp_path / "missing.db"
    with pytest.raises(RuntimeError, match="CUDA"):
        puzzle.main(["--model", str(tmp_path / "m.ckpt"), "--puzzle-db", str(db), "--net", "tiny3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench.main(["--net", "tiny3"])
    # One-process training: the co-scheduled driver and tiny_run.
    from takzero_torch import tiny_run
    from takzero_torch.drivers import coscheduled

    with pytest.raises(RuntimeError, match="CUDA"):
        coscheduled.main(["--directory", str(tmp_path), "--net", "tiny3", "--max-moves", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tiny_run.main(["--out", str(tmp_path / "tiny_run.json")])
    assert not any(tmp_path.iterdir())
    # The EEE experiments and the search visualizer.
    from takzero_torch.drivers import eee, visualize_search

    replays = tmp_path / "replays.txt"
    replays.write_text('[TPS "x3/x3/x3 1 1"] a1 c3\n')
    for argv in (["rnd", "--replays", str(replays)], ["generalization", "--replays", str(replays)],
                 ["ensemble", "--targets", str(replays)], ["seen-ratio", "--model", str(replays)]):
        with pytest.raises(RuntimeError, match="CUDA"):
            eee.main(argv + ["--out", str(tmp_path / "eee.csv")] if argv[0] != "seen-ratio" else argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        visualize_search.main(["--net", "tiny3", "--out-dir", str(tmp_path)])
    # The replay visualizers step the replays on the card too.
    from takzero_torch.drivers import graph, visualize_replay_buffer

    with pytest.raises(RuntimeError, match="CUDA"):
        graph.main([str(replays), "--n", "3", "--out", str(tmp_path / "graph.html")])
    with pytest.raises(RuntimeError, match="CUDA"):
        visualize_replay_buffer.main([str(replays), str(replays), "--n", "3",
                                      "--out-prefix", str(tmp_path / "positions")])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["replays.txt"]
    # The tools that use the card: the puzzle prover, the Elo curve's
    # evaluation subprocesses, the reuse A/B and the anchor's network half.
    from takzero_torch.tools import anchor, elo_curve, make_puzzles, reuse_ab

    with pytest.raises(RuntimeError, match="CUDA"):
        make_puzzles.main(["--out", str(tmp_path / "p.db"), "--size", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        elo_curve.main(["--directory", str(tmp_path), "--net", "tiny3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        reuse_ab.main(["--ckpt", str(tmp_path / "m.ckpt"), "--net", "tiny3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        anchor.main(["--quick"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["replays.txt"]
    assert resolve_device("cpu") == torch.device("cpu")
