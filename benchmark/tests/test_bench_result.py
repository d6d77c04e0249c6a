"""The run's last line, the import guard, and a run without a card."""

import io
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import result, spec


def test_last_line_shape_and_checks_last():
    out, err = io.StringIO(), io.StringIO()
    checks = {"logit_err": {"value": 0.03, "limit": 0.1}, "rules_errors": {"value": 0, "limit": 0}}
    result.emit(True, 640, 0, {"setup_s": {"value": 9.8, "unit": "s"}},
                {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 1},
                checks, breakdown={"device_ops": [["k", 1e-3]], "idle_gaps": []}, out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert line["metrics"]["setup_s"] == {"value": 9.8, "unit": "s"}
    assert err.getvalue().strip().splitlines()[-2:] == [
        "check logit_err: 0.03 (limit 0.1)", "check rules_errors: 0 (limit 0)"]


def test_outcome_reports_the_cells_metrics_only():
    bench = spec.benchmark()
    cell = spec.workload(bench, "selfplay.net5")
    got = result.outcome(bench, cell, {"setup_s": 1.0, "selfplay_sims_per_s": 2.0, "serve_nodes_per_s": 3.0},
                         None, 0, True, {}, attempted=1, failed=0, on_card=False)
    assert set(got["metrics"]) == {"setup_s", "selfplay_sims_per_s"}


def test_import_guard_compares_whole_top_level_names():
    assert result.forbidden_modules({"takzero_torch": 1, "takzero_torch.search": 1, "jaxtyping": 1}) == []
    assert result.forbidden_modules({"jax.numpy": 1, "takzero_tpu.ops": 1, "flax": 1}) == ["flax", "jax",
                                                                                            "takzero_tpu"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "selfplay.net6_simhash",
                           "--seed", "2147483749", "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in proc.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "selfplay.net5",
                           "--seed", "2147483777", "--seconds", "5", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
