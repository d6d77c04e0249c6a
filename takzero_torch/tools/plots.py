"""Matplotlib plots (reference python/{plot_elo_data,plot_eee,
extract_from_logs,novelty_per_depth}.py).

The port's copy of ``takzero_tpu/tools/plots.py``.  All savefig-based so
they run headless.  matplotlib is imported only when a figure is drawn
(the drivers' ``--png``, the tools' ``--plot``): where it is not
installed, that raises an ``ImportError`` naming the flag, and the CSV,
JSON, HTML and SVG outputs, which never need it, are written all the same.
"""

from __future__ import annotations

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "--png and --plot need matplotlib, which is not installed here; the CSV, JSON, HTML and SVG"
            " outputs do not"
        ) from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_elo(curves: dict, out_path) -> None:
    """Elo-vs-steps with stderr bands ({model: [(steps, elo, err)]})."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 6))
    for model, pts in curves.items():
        steps = [p[0] for p in pts]
        elo = np.array([p[1] for p in pts])
        err = np.array([p[2] for p in pts])
        ax.fill_between(steps, elo - err, elo + err, alpha=0.2)
        ax.plot(steps, elo, label=model)
    ax.legend()
    ax.grid(True)
    ax.set_xlabel("training steps")
    ax.set_ylabel("relative bayes elo")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def plot_losses(metrics: list[dict], keys, out_prefix, window: int = 128) -> None:
    """One figure per loss key: raw + moving average."""
    from .logs import moving_average

    plt = _plt()
    steps = [m["step"] for m in metrics]
    for key in keys:
        vals = [m.get(key) for m in metrics]
        if any(v is None for v in vals):
            continue
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.plot(steps, vals, label="Raw", alpha=0.5)
        ma = moving_average(vals, window)
        if len(ma) < len(steps):
            ax.plot(steps[window - 1 :], ma, label=f"Moving Average (n={window})")
        ax.set_title(f"{key} During Training")
        ax.set_xlabel("Training Steps")
        ax.set_ylabel("Loss")
        ax.legend()
        ax.grid(True)
        fig.savefig(f"{out_prefix}{key}.png", bbox_inches="tight")
        plt.close(fig)


def plot_eee(csv_path, out_path, window: int = 100) -> None:
    """EEE data curves (reference python/plot_eee.py): one line per
    column of eee_data.csv, moving-averaged."""
    from .logs import moving_average

    plt = _plt()
    with open(csv_path, "r", encoding="utf-8") as f:
        header = f.readline().strip().split(",")
        rows = [list(map(float, line.split(","))) for line in f if line.strip()]
    data = np.array(rows)
    fig, ax = plt.subplots(figsize=(10, 6))
    for i, col in enumerate(header[1:], start=1):
        y = moving_average(data[:, i], min(window, max(1, len(data) // 10)))
        # End-aligned: y[j] averages a window ending at row len(data)-len(y)+j.
        ax.plot(data[len(data) - len(y) :, 0], y, label=col)
    ax.legend()
    ax.grid(True)
    ax.set_xlabel("step")
    ax.set_ylabel("normalized surprise / novelty")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def plot_uniqueness(curves: dict, out_path) -> None:
    """Replay-buffer uniqueness vs positions ({run: [(positions, frac)]}),
    the figures/replay_buffer_uniqueness.png analog for ``drivers/graph.py``
    (Yaniv metric, graph/src/main.rs:45-96)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 6))
    for name, pts in curves.items():
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker=".", label=name)
    ax.set_xlabel("positions seen")
    ax.set_ylabel("new-unique fraction per chunk")
    ax.set_ylim(0, 1.02)
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_seen_ratio(pairs, out_path) -> None:
    """Unseen-ratio vs ply (reference python/novelty_per_depth.py)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot([p for p, _ in pairs], [r for _, r in pairs])
    ax.set_xlabel("ply")
    ax.set_ylabel("unseen ratio")
    ax.grid(True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("eee")
    p.add_argument("csv")
    p.add_argument("--out", default="eee.png")
    p.add_argument("--window", type=int, default=100)
    args = parser.parse_args(argv)
    if args.cmd == "eee":
        plot_eee(args.csv, args.out, window=args.window)


if __name__ == "__main__":
    main()
