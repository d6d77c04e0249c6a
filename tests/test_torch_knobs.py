"""The JAX package's last knobs in the port, and a guard that every flag and
``TAKZERO_*`` variable of the JAX package has its counterpart.

* ``TAKZERO_LEARN_TIMING``: the learner logs JAX's ``chunk timing`` line
  once per chunk, and not without the variable;
* ``tools/anchor.py --write --baseline PATH`` writes the anchor under
  ``"published"`` in PATH and leaves ``BASELINE.json`` as it is;
* ``tools/scatter_variants.py --dtype``;
* ``tools/pool_cliff.py --dump-hlo DIR``: one profiler table per pool size;
* every ``add_argument("--...")`` flag and every ``TAKZERO_*`` variable
  that a module of ``takzero_tpu`` (or the root ``bench.py``) reads is
  read by the module's counterpart in ``takzero_torch``, found by parsing
  both (no JAX import).  None is excepted: the one JAX feature replaced by
  design behind a flag, ``--dump-hlo``, keeps its flag.
"""

import ast
import json
import logging
import re
from pathlib import Path

import numpy as np
import torch

from takzero_torch.drivers import learn
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tools import anchor, pool_cliff, scatter_variants
from takzero_torch.train.data import random_pretraining_targets

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TIMING = re.compile(r"^chunk timing: assemble=\d+\.\d{3}s stack\+dispatch=\d+\.\d{3}s flush=\d+\.\d{3}s \(c=(\d+)\)$")


def _learn_with_targets(d: Path, caplog, *extra) -> list[int]:
    """Pre-train tiny3, write 48 targets, train in chunks of up to 3; the
    chunk sizes of the timing lines of the second run."""
    base = ["--directory", str(d), "--net", "tiny3", "--batch-size", "8", "--no-wait", "--device", "cpu"]
    learn.main(base + ["--seed", "1", "--pretrain-targets", "16", "--pretrain-steps", "1", "--max-steps", "0"])
    lines = [t.to_line() for t in random_pretraining_targets(torch_engine(3), 48, np.random.default_rng(9),
                                                             device="cpu")]
    (d / "targets-selfplay.txt").write_text("\n".join(lines) + "\n")
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="learn"):
        learn.main(base + ["--pretrain-steps", "0", "--max-steps", "5", "--chunk-steps", "3", *extra])
    return [int(m.group(1)) for r in caplog.records if (m := TIMING.match(r.getMessage()))]


def test_learn_timing_line_once_per_chunk(tmp_path, caplog, monkeypatch):
    monkeypatch.setenv("TAKZERO_LEARN_TIMING", "1")
    chunks = _learn_with_targets(tmp_path / "on", caplog)
    steps = [json.loads(line)["step"] for line in (tmp_path / "on" / "metrics.jsonl").read_text().splitlines()]
    assert chunks == [3, 2] and sum(chunks) == len([s for s in steps if s > 1])
    monkeypatch.delenv("TAKZERO_LEARN_TIMING")
    assert _learn_with_targets(tmp_path / "off", caplog) == []


def test_anchor_write_goes_to_the_named_file(tmp_path, monkeypatch):
    baseline = (REPO / "BASELINE.json").read_bytes()
    monkeypatch.setattr(anchor, "measure_search", lambda quick: {"sims_per_s": 1000.0})
    monkeypatch.setattr(anchor, "measure_nn", lambda quick, dev: {"positions_per_s": 3000.0, "threads": 2})
    path = tmp_path / "sub" / "baseline.json"
    out = anchor.main(["--quick", "--device", "cpu", "--write", "--baseline", str(path)])
    assert json.loads(path.read_text()) == {"published": out}
    assert out["reference_on_this_host_sims_per_s_per_actor"] == 750.0
    path.write_text(json.dumps({"published": {"kept": 1}, "other": 2}))
    anchor.main(["--quick", "--device", "cpu", "--write", "--baseline", str(path)])
    assert json.loads(path.read_text()) == {"published": {"kept": 1, **out}, "other": 2}
    assert (REPO / "BASELINE.json").read_bytes() == baseline
    assert anchor.BASELINE == REPO / "build" / "baseline_h100.json"


def test_scatter_variants_dtype(capsys):
    small = ["--device", "cpu", "--pools", "12", "--batch", "2", "--children", "8", "--depth", "4", "--iters", "2"]
    for dtype in ("float32", "bfloat16"):
        rows = scatter_variants.main(small + ["--dtype", dtype])
        assert {r["dtype"] for r in rows} == {dtype} and all(r["equal_to_core"] for r in rows)
    assert {r["dtype"] for r in scatter_variants.main(small)} == {"int32"}


def test_pool_cliff_dump_hlo_writes_one_table_per_pool(tmp_path, capsys):
    rows = pool_cliff.main(["--device", "cpu", "--stub", "--pools", "12,24", "--batch", "2", "--children", "8",
                            "--sims", "2", "--reps", "1", "--dump-hlo", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pool_cliff_M12.txt", "pool_cliff_M24.txt"]
    assert all("histogram" not in r for r in rows)
    table = (tmp_path / "pool_cliff_M24.txt").read_text().splitlines()
    assert table[0].startswith("# 2 simulations")
    counts = [int(line.split("\t")[0]) for line in table[1:]]
    assert counts == sorted(counts, reverse=True) and any("aten::" in line for line in table)


def _flags(path: Path) -> set[str]:
    """The ``--`` flags of every ``add_argument`` call in a module."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str) and a.value.startswith("--")}
    return flags


def _env_vars(path: Path) -> set[str]:
    """Every string constant of a module that is a whole ``TAKZERO_*`` name."""
    return {node.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and re.fullmatch(r"TAKZERO_[A-Z0-9_]+", node.value)}


# Counterparts that live at another path in the port.
MOVED = {"takzero_tpu/tools/serve_bench.py": "takzero_torch/serve_bench.py", "bench.py": "takzero_torch/bench.py"}


def test_every_jax_flag_and_env_var_has_a_counterpart():
    modules = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "takzero_tpu").rglob("*.py")) + ["bench.py"]
    missing, checked = [], 0
    for rel in modules:
        want_flags, want_env = _flags(REPO / rel), _env_vars(REPO / rel)
        if not want_flags and not want_env:
            continue
        port = REPO / MOVED.get(rel, rel.replace("takzero_tpu/", "takzero_torch/", 1))
        if not port.exists():
            missing.append(f"{rel}: no counterpart at {port.relative_to(REPO)}")
            continue
        checked += 1
        for name in sorted(want_flags - _flags(port)) + sorted(want_env - _env_vars(port)):
            missing.append(f"{rel}: {name} not read by {port.relative_to(REPO)}")
    assert not missing, "\n".join(missing)
    assert checked >= 30  # the drivers, tools and bench: the scan found them
