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
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 25, out.stdout  # every module of the port was imported


def test_entry_points_default_to_cuda(monkeypatch):
    from takzero_torch import bench
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
    assert resolve_device("cpu") == torch.device("cpu")
