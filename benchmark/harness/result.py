"""The card, the import guard and the run's last line."""

from __future__ import annotations

import json
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "takzero_tpu")


class NoCard(RuntimeError):
    """The run finds fewer cards than its cell asks for."""


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is the JAX
    package's or JAX's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi``, or ``None``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(chips: int, peak_bytes: int) -> dict:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(peak_bytes),
        "power_limit_w": power_limit_w(),
    }


def judge(values: dict, limits: dict) -> tuple:
    """(correct, checks): every compared number beside its limit; correct
    when none is over."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(values[k] <= limits[k] for k in limits), checks


def outcome(bench: dict, cell: dict, e2e: dict, trace, peak: int, correct: bool, checks: dict,
            attempted: int, failed: int, on_card: bool = True) -> dict:
    """The keyword arguments of :func:`emit` for one run: without a trace
    the cell's end-to-end metrics (from ``e2e``), with one its per-layer
    metrics (each metric's reader on ``trace``), the device's busy and
    window seconds and the breakdown."""
    from . import spec
    from .trace import breakdown, busy_us

    device = device_record(cell["chips"], peak) if on_card else {"platform": "cpu"}
    metrics, brk = {}, None
    if trace is None:
        for m in spec.metrics_for(bench["end_to_end"], cell["name"]):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec.metrics_for(bench["per_layer"], cell["name"]):
            value = spec.reader(m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        sl = trace.slices.get("device")
        if sl is not None:
            device.update(busy_s=busy_us(sl.device) / 1e6, window_s=sl.wall_s)
            units, seconds = trace.window.get("units"), trace.window.get("seconds")
            if units:
                print(f"profiler: {sl.wall_s / sl.units:.6f} s a unit under the device slice, "
                      f"{seconds / units:.6f} s in the window", file=sys.stderr)
        brk = breakdown(trace)
    return dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics, device=device,
                checks=checks, breakdown=brk)


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: dict,
         breakdown: dict | None = None, out=None, err=None) -> dict:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output
    (``checks`` its last key)."""
    out = out or sys.stdout
    err = err or sys.stderr
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return line
