"""Elo-vs-steps curve for one training run, end to end.

Counterpart of ``takzero_tpu/tools/elo_curve.py`` (the reference's
evaluation -> python/get_match_results.py -> python/elo.py pipeline) over a
run directory of the port's numbered checkpoints:

1. play a deterministic match schedule with the port's pit fighter
   (``python -m takzero_torch.drivers.evaluation ... --device DEV``), ONE
   checkpoint pair per subprocess, its match lines teed into
   ``<dir>/eval_curve.log``;
2. scrape matches into ``<dir>/match_results.csv`` (tools/match_results);
3. fit relative Bayes-Elo (tools/elo.py) and write
   ``<dir>/elo_curve.json`` — ``[{steps, elo, stderr}, ...]`` — plus an
   optional ``elo_curve.png`` (tools/plots.py).

One pair per subprocess bounds each process's lifetime (the driver's RSS
watchdog exits 42 long before the oom-killer), and before every (re)launch
a probe subprocess runs one tiny torch op on the requested device (skipped
on the CPU).  ``eval_curve.log`` doubles as resume state: pairs whose
both-colour lines are logged are skipped, so the schedule survives any
number of restarts.

One deliberate difference from JAX's tool: a retried pair can log the same
directed match twice (a subprocess killed after its first line, then run
again with the same seed).  JAX's fit counts both lines; here only the LAST
line of each directed (a, b) pair counts, both when picking what to play
and in the fit.

Usage:
    python -m takzero_torch.tools.elo_curve --directory RUN --net NET
        [--rounds N] [--step 1] [--games 32] [--budget 768] [--sampled 64]
        [--attempts 4] [--skip-matches] [--plot] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import re
import subprocess
import sys
import time

from ..device import resolve_device

log = logging.getLogger("elo_curve")

_MATCH = re.compile(r"INFO:evaluation:(\S+) vs\. (\S+): Evaluation")

PROBE_SRC = "import sys, torch; torch.ones((4, 4), device=sys.argv[1]).add(1).cpu(); print('probe-ok')"


def pair_schedule(names: list[str]) -> list[tuple[str, str]]:
    """Deterministic pair order: adjacent first, then widening distances.

    Adjacent pairs connect the whole chain (the minimum for a Bayes-Elo
    fit); each extra distance band tightens the fit.  Within a band,
    low-step pairs first.
    """
    n = len(names)
    return [(names[i], names[i + d]) for d in range(1, n) for i in range(n - d)]


def match_lines(directory: pathlib.Path) -> list[str]:
    """The match lines of the eval logs, the last line of each directed
    (a, b) pair only, in the order of those last lines."""
    last: dict[tuple[str, str], tuple[int, str]] = {}
    text = "".join(p.read_text(encoding="utf-8") for p in sorted(pathlib.Path(directory).glob("eval*.log")))
    for i, line in enumerate(text.splitlines(keepends=True)):
        m = _MATCH.search(line)
        if m:
            last[(m.group(1), m.group(2))] = (i, line)
    return [line for _, line in sorted(last.values())]


def played_pairs(directory: pathlib.Path) -> set[tuple[str, str]]:
    """Directed matches already present in the resumable eval logs."""
    return {tuple(_MATCH.search(line).groups()) for line in match_lines(directory)}


def probe_device(device: str, timeout_s: int) -> bool:
    """True when a tiny op on ``device`` round-trips within ``timeout_s``."""
    if device == "cpu":
        return True  # nothing to probe
    try:
        out = subprocess.run([sys.executable, "-c", PROBE_SRC, device], timeout=timeout_s,
                             capture_output=True, text=True)
        return "probe-ok" in out.stdout
    except subprocess.TimeoutExpired:
        return False


def wait_for_device(args) -> None:
    while not probe_device(args.device, args.probe_timeout):
        log.warning("device probe failed; sleeping %ds", args.probe_interval)
        time.sleep(args.probe_interval)


def run_matches(args) -> pathlib.Path:
    d = pathlib.Path(args.directory)
    log_path = d / "eval_curve.log"
    names = [p.name for p in _scan(d, args.step)]
    if len(names) < 2:
        raise SystemExit(f"need >=2 numbered checkpoints in {d}")
    schedule = pair_schedule(names)
    done = played_pairs(d)
    todo = [(i, p) for i, p in enumerate(schedule) if not ((p[0], p[1]) in done and (p[1], p[0]) in done)]
    if args.rounds is not None:
        todo = todo[: args.rounds]
    log.info("%d checkpoints, %d pairs scheduled, %d already logged, %d to play",
             len(names), len(schedule), len(schedule) - len(todo), len(todo))
    for idx, (a, b) in todo:
        cmd = [
            sys.executable, "-m", "takzero_torch.drivers.evaluation",
            "--model-path", str(d), "--net", args.net, "--pair", f"{a},{b}",
            "--games", str(args.games), "--budget", str(args.budget), "--sampled", str(args.sampled),
            "--seed", str(args.seed * 1000 + idx), "--rss-limit-gb", str(args.rss_limit_gb),
            "--device", args.device,
        ]
        if args.opening_book:
            cmd += ["--opening-book", args.opening_book]
        for attempt in range(1, args.attempts + 1):
            wait_for_device(args)
            log.info("pair %s vs %s (attempt %d/%d)", a, b, attempt, args.attempts)
            t0 = time.time()
            with open(log_path, "a", encoding="utf-8") as f:
                # The driver logs matches on stderr; tee into the resume log
                # line by line so a mid-match kill loses nothing logged.
                proc = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
                for line in proc.stderr:
                    sys.stderr.write(line)
                    if _MATCH.search(line):
                        f.write(line)
                        f.flush()
                proc.wait()
            if proc.returncode == 0:
                log.info("pair done in %.0fs", time.time() - t0)
                break
            log.warning("evaluation subprocess rc=%d after %.0fs%s", proc.returncode, time.time() - t0,
                        " (RSS leak guard tripped)" if proc.returncode == 42 else "")
        else:
            log.error("pair %s vs %s failed %d attempts — skipping", a, b, args.attempts)
    return log_path


def _scan(d: pathlib.Path, step: int) -> list[pathlib.Path]:
    from ..drivers.evaluation import scan_checkpoints

    return scan_checkpoints(d, step)


def fit_and_write(args) -> list[dict]:
    from .elo import elo_curves, read_results
    from .match_results import scrape

    d = pathlib.Path(args.directory)
    csv_lines = scrape("".join(match_lines(d)))
    if not csv_lines:
        raise SystemExit(f"no match lines found in {d}/eval*.log")
    csv_path = d / "match_results.csv"
    csv_path.write_text("".join(csv_lines), encoding="utf-8")
    curves = elo_curves(read_results(csv_path))
    # One run directory = one model family ("model_<steps>.ckpt").
    (model, points), = curves.items()
    rows = [{"steps": s, "elo": round(e, 1), "stderr": round(se, 1)} for s, e, se in points]
    out = d / "elo_curve.json"
    out.write_text(json.dumps({"model": model, "matches": len(csv_lines), "curve": rows}, indent=2) + "\n",
                   encoding="utf-8")
    for r in rows:
        log.info("steps %8d: elo %+7.1f +- %.1f", r["steps"], r["elo"], r["stderr"])
    log.info("wrote %s (%d matches)", out, len(csv_lines))
    if args.plot:
        from .plots import plot_elo

        plot_elo(curves, d / "elo_curve.png")
        log.info("wrote %s", d / "elo_curve.png")
    return rows


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--directory", required=True)
    parser.add_argument("--net", default="net6_simhash")
    parser.add_argument("--rounds", type=int, default=None, help="cap on pairs to play this invocation")
    parser.add_argument("--step", type=int, default=1)
    parser.add_argument("--games", type=int, default=32)
    parser.add_argument("--budget", type=int, default=768)
    parser.add_argument("--sampled", type=int, default=64)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--opening-book", default=None)
    parser.add_argument("--attempts", type=int, default=4, help="max launches per pair before skipping it")
    parser.add_argument("--rss-limit-gb", type=float, default=48.0)
    parser.add_argument("--probe-timeout", type=int, default=90)
    parser.add_argument("--probe-interval", type=int, default=150)
    parser.add_argument("--skip-matches", action="store_true", help="only scrape + fit existing eval*.log files")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device of the evaluation subprocesses")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if not args.skip_matches:
        resolve_device(args.device)  # raises here, not in every subprocess
        run_matches(args)
    return fit_and_write(args)


if __name__ == "__main__":
    main()
