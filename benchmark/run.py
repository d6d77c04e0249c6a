"""Runs one cell of the port's benchmark once, on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``BENCHMARK.json``).  Every run checks what the
measured path produced against the plain reference under
``benchmark/reference/`` and prints ``correct``.  It exits with 2 and
prints no result without the cards the cell asks for, and with 3 when a
module of JAX or of the JAX package was loaded.

Everything the program builds or caches stays in ``build/`` of the
checkout, at fixed paths.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark.harness import result, spec  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    try:
        result.require_cards(cell["chips"])
    except result.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    cache_dirs(spec.ROOT)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    outcome = kind.run(bench, cell, cfg, traffic, args, t_start=T0)
    found = result.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; nothing of JAX may run", file=sys.stderr)
        return 3
    result.emit(**outcome)
    return 0


if __name__ == "__main__":
    sys.exit(main())
