"""Readings of a cell's check over many seeds, for the program and for its
control (the reference in the next lower precision put in the program's
place), in one process so that the kernels build once:

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,13 --seconds 20 [--out FILE]

Prints one JSON line per seed (``program`` and ``control`` readings) and a
last line with the largest program reading and the smallest control
reading of each number.  The limits in ``limits/<cell>.json`` are set
between the two.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

from benchmark.harness import result, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only (default all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    try:
        result.require_cards(cell["chips"])
    except result.NoCard as e:
        print(f"calibrate: {e}", file=sys.stderr)
        return 2
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    seeds = [int(s) for s in args.seeds.split(",")]
    lines, hi, lo = [], {}, {}
    for i, seed in enumerate(seeds):
        prog, ctrl = kind.calibrate(cell, cfg, traffic, seed, args.seconds,
                                    control=args.control_seeds is None or i < args.control_seeds)
        line = {"seed": seed, "program": prog, "control": ctrl}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for k, v in prog.items():
            if not k.startswith("_") and isinstance(v, (int, float)):
                hi[k] = max(hi.get(k, v), v)
        for k, v in (ctrl or {}).items():
            if "._" not in k and not k.startswith("_") and isinstance(v, (int, float)):
                lo[k] = min(lo.get(k, v), v)
    summary = {"workload": args.workload, "seeds": len(seeds), "program_max": hi, "control_min": lo}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines + [summary]) + "\n")
    found = result.forbidden_modules()
    if found:
        print(f"calibrate: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
