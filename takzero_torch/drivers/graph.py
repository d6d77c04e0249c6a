"""Replay-buffer uniqueness curves (reference graph/src/main.rs).

Counterpart of ``takzero_tpu/drivers/graph.py``.  For each replay file,
walks every position of every replay in order and computes the "Yaniv
metric": per chunk of ``point_rate`` positions, the fraction that were
never seen before (new-unique / positions).  Prints a Python-literal point
list per run (like the reference) and renders all curves into a
self-contained ``graph.html`` (inline SVG, written byte for byte as JAX's).
The replays of a block of lines are replayed together on the port's
engine on ``--device`` (default ``cuda``, which raises without CUDA;
``--device cpu`` runs on the CPU); only the positions come back to the
host for their TPS.

Usage:
    python -m takzero_torch.drivers.graph --n 4 run1_replays.txt run2_replays.txt \
        [--csv curves.csv] [--png curves.png] [--device cuda]
"""

from __future__ import annotations

import argparse
import html
import pathlib


def unique_position_curve(n: int, path, positions_cap: int = 10_000_000, point_rate: int = 250_000,
                          device=None):
    """[(positions, new_unique_fraction)], keyed by literal TPS (the
    reference keys full game states, commented canonical();
    graph/src/main.rs:84-89).  The replays are stepped on ``device``
    (default ``cuda``; raises without CUDA)."""
    from ..data.native_loader import replay_line_tps
    from ..device import resolve_device
    from ..tak.engine import engine

    max_points = positions_cap // point_rate
    seen: set[str] = set()
    points = [(0.0, 1.0)]
    count = prev_count = prev_unique = 0
    for tps in replay_line_tps(engine(n), path, resolve_device(device)):
        if count // point_rate >= len(points):
            diff = count - prev_count
            points.append((float(count), (len(seen) - prev_unique) / diff))
            prev_count, prev_unique = count, len(seen)
        if len(points) > max_points:
            break
        seen.update(tps)
        count += len(tps)
    return points


def render_html(curves: dict[str, list], out_path, width=1200, height=800) -> None:
    """Self-contained SVG line chart with legend."""
    pad = 60
    xs = [x for pts in curves.values() for x, _ in pts]
    ys = [y for pts in curves.values() for _, y in pts]
    xmax = max(xs) if xs else 1.0
    ymax = max(ys) if ys else 1.0
    colors = ["#c1232b", "#27727b", "#fcce11", "#e87c25", "#b5c334", "#6a3d9a"]

    def sx(x):
        return pad + (width - 2 * pad) * (x / max(xmax, 1e-9))

    def sy(y):
        return height - pad - (height - 2 * pad) * (y / max(ymax, 1e-9))

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<line x1="{pad}" y1="{height-pad}" x2="{width-pad}" y2="{height-pad}" stroke="#333"/>',
        f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{height-pad}" stroke="#333"/>',
        f'<text x="{width//2}" y="{height-15}" text-anchor="middle">positions</text>',
        f'<text x="15" y="{height//2}" transform="rotate(-90 15 {height//2})" '
        f'text-anchor="middle">new unique / positions</text>',
    ]
    for i in range(5):
        y = ymax * i / 4
        parts.append(
            f'<text x="{pad-8}" y="{sy(y)+4}" text-anchor="end" font-size="11">'
            f"{y:.2f}</text>"
        )
    for i, (name, pts) in enumerate(curves.items()):
        color = colors[i % len(colors)]
        poly = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
        parts.append(
            f'<polyline points="{poly}" fill="none" stroke="{color}" stroke-width="2"/>'
        )
        ly = pad + 20 * i
        parts.append(
            f'<rect x="{width-pad-180}" y="{ly-10}" width="12" height="12" fill="{color}"/>'
            f'<text x="{width-pad-160}" y="{ly}" font-size="13">{html.escape(name)}</text>'
        )
    parts.append("</svg>")
    pathlib.Path(out_path).write_text(
        "<!DOCTYPE html><html><body>" + "".join(parts) + "</body></html>",
        encoding="utf-8",
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("replays", nargs="+", help="replay files")
    parser.add_argument("--n", type=int, default=4)
    parser.add_argument("--positions", type=int, default=10_000_000)
    parser.add_argument("--point-rate", type=int, default=250_000)
    parser.add_argument("--out", default="graph.html")
    parser.add_argument("--png", default=None,
                        help="also render a matplotlib figure (the "
                        "figures/replay_buffer_uniqueness.png analog; needs matplotlib)")
    parser.add_argument("--csv", default=None,
                        help="also write name,positions,unique_fraction rows")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    curves = {}
    for path in args.replays:
        name = pathlib.Path(path).stem.replace("_replays", "")
        pts = unique_position_curve(args.n, path, positions_cap=args.positions, point_rate=args.point_rate,
                                    device=args.device)
        curves[name] = pts
        print(f"{name} = [")
        for x, y in pts:
            print(f"    ({x}, {y}),")
        print("]")
    render_html(curves, args.out)
    print(f"wrote {args.out}")
    if args.csv:
        with open(args.csv, "w", encoding="utf-8") as f:
            f.write("run,positions,unique_fraction\n")
            for name, pts in curves.items():
                for x, y in pts:
                    f.write(f"{name},{int(x)},{y:.6f}\n")
        print(f"wrote {args.csv}")
    if args.png:
        from ..tools.plots import plot_uniqueness

        plot_uniqueness(curves, args.png)
        print(f"wrote {args.png}")
    return curves


if __name__ == "__main__":
    main()
