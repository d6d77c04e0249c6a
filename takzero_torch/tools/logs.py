"""Extract training metrics from learner output
(reference python/extract_from_logs.py).

The port's copy of ``takzero_tpu/tools/logs.py``.  Two sources:
* ``metrics.jsonl`` written by the learn driver (one JSON object per
  step);
* regex scraping of learner stderr/log text (``step N: loss=... policy=...
  value=... ube=...``) for runs where only logs survive.
``moving_average`` also smooths the EEE plots.
"""

from __future__ import annotations

import json
import pathlib
import re

import numpy as np

STEP_PATTERN = re.compile(
    r"step (\d+): loss=([\d.]+) policy=([\d.]+) value=([\d.]+) ube=([\d.]+)"
)


def moving_average(a, n: int = 128):
    a = np.asarray(a, float)
    if len(a) < n:
        return a
    ret = np.cumsum(a)
    ret[n:] = ret[n:] - ret[:-n]
    return ret[n - 1 :] / n


def read_metrics_jsonl(path) -> list[dict]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def scrape_log(text: str) -> list[dict]:
    return [
        {
            "step": int(m[1]),
            "loss": float(m[2]),
            "loss_policy": float(m[3]),
            "loss_value": float(m[4]),
            "loss_ube": float(m[5]),
        }
        for m in re.finditer(STEP_PATTERN, text)
    ]


def load_metrics(path) -> list[dict]:
    path = pathlib.Path(path)
    if path.suffix == ".jsonl":
        return read_metrics_jsonl(path)
    return scrape_log(path.read_text(encoding="utf-8", errors="replace"))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("source", help="metrics.jsonl or learner log file")
    parser.add_argument("--out-csv", help="write merged metrics CSV here")
    parser.add_argument("--plot", help="write loss plot(s) to this file prefix")
    parser.add_argument("--window", type=int, default=128)
    args = parser.parse_args(argv)

    metrics = load_metrics(args.source)
    print(f"{len(metrics)} steps")
    if not metrics:
        return
    keys = [k for k in metrics[0] if k != "step"]
    if args.out_csv:
        with open(args.out_csv, "w", encoding="utf-8") as f:
            f.write("step," + ",".join(keys) + "\n")
            for m in metrics:
                f.write(f"{m['step']}," + ",".join(str(m.get(k, "")) for k in keys) + "\n")
    if args.plot:
        from .plots import plot_losses

        plot_losses(metrics, keys, args.plot, window=args.window)


if __name__ == "__main__":
    main()
