"""Radial SVG visualization of the search tree
(reference visualize_search/src/main.rs).

Counterpart of ``takzero_tpu/drivers/visualize_search.py``: runs a plain
PUCT search (a batch of one tree, ``make_simulate`` of the port, kernel A
once per simulation on the card) at each beta in {0, 0.5, 1, 2, 3, 4}
from a given TPS position and renders the tree as a radial SVG, written
byte for byte as JAX's from the same tree: one circle per expanded node
(opacity proportional to visits, TPS in a ``tps`` attribute for hover
tooltips), edges fanning children over the parent's angular sector.

Without ``--tps`` the opening (3 random plies) comes from a torch
generator seeded 0, not from JAX's ``PRNGKey(0)``, so it is another
position than JAX's.

Usage:
    python -m takzero_torch.drivers.visualize_search --net net4_rnd \
        [--model CKPT] [--tps "..."] [--visits 1000] [--out-dir .] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import pathlib

import numpy as np

ARM_LENGTH = 40.0
CIRCLE_RADIUS = 6.0
COLOR = "#8142f5"

PREVIEW_JS = """
const tip = document.createElementNS('http://www.w3.org/2000/svg','text');
tip.setAttribute('font-size','12'); tip.setAttribute('fill','#111');
document.documentElement.appendChild(tip);
for (const c of document.querySelectorAll('circle')) {
  c.addEventListener('mouseenter', () => {
    tip.textContent = c.getAttribute('tps') || '';
    tip.setAttribute('x', Number(c.getAttribute('cx')) + 10);
    tip.setAttribute('y', Number(c.getAttribute('cy')) - 10);
  });
}
"""


def opacity(visits: int) -> float:
    return max(0.0, min(1.0, visits / 25.0))


def draw_tree(parts, tree, node: int, x: float, y: float, a0: float, a1: float,
              node_visits: int, tps: str, n: int):
    """Recursive radial layout over the host-copied tree arrays."""
    parts.append(
        f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{CIRCLE_RADIUS}" fill="{COLOR}" '
        f'opacity="{opacity(node_visits):.3f}" tps="{tps}"/>'
    )
    actions = tree["child_action"][node]
    valid = np.nonzero(actions >= 0)[0]
    if len(valid) == 0:
        return
    step = (a1 - a0) / len(valid)
    for i, slot in enumerate(valid):
        visits = int(tree["child_visit"][node, slot])
        if visits < 1:
            continue
        ang = a0 + step * i
        x2 = x + ARM_LENGTH * math.cos(ang)
        y2 = y + ARM_LENGTH * math.sin(ang)
        parts.append(
            f'<line x1="{x:.1f}" y1="{y:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="{COLOR}" stroke-width="1" opacity="{opacity(visits):.3f}"/>'
        )
        child = int(tree["child_node"][node, slot])
        if child >= 0:
            child_tps = tree["node_tps"][child]
            draw_tree(
                parts, tree, child, x2, y2, ang - step / 2, ang + step / 2,
                visits, child_tps, n,
            )


def visualize(tree_arrays, n: int, beta: float, out_dir) -> pathlib.Path:
    parts = [
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="-400 -400 1000 1000">'
    ]
    root_visits = int(tree_arrays["root_visit"])
    draw_tree(
        parts, tree_arrays, 0, 0.0, 0.0, 0.0, 2 * math.pi,
        root_visits, tree_arrays["node_tps"][0], n,
    )
    parts.append(f"<script><![CDATA[{PREVIEW_JS}]]></script></svg>")
    path = pathlib.Path(out_dir) / f"tree_with_beta={beta}.svg"
    path.write_text("".join(parts), encoding="utf-8")
    return path


def search_tree(eng, simulate, envs, beta: float, visits: int, max_children: int):
    """One tree of ``visits + 8`` nodes and ``max_children`` slots searched
    ``visits`` times from ``envs`` (a batch of one position) at ``beta``."""
    import torch

    from ..search.tree import init_tree

    tree = init_tree(eng, envs, visits + 8, max_children)
    betas = torch.full((1,), beta, device=envs.ply.device)
    for _ in range(visits):
        tree = simulate(tree, betas)
    return tree


def host_arrays(tree, n: int) -> dict:
    """The arrays of tree 0 that :func:`visualize` draws, on the host.
    ``node_tps`` is empty for a row that is not live: ``node_live`` is the
    live set (a prefix bound from ``node_count`` holds only for fresh
    trees)."""
    from ..tak.tps import states_to_tps

    live = tree.node_live[0].cpu().numpy()
    tps = states_to_tps(n, tree.node_env.map(lambda x: x[0].cpu()))
    return {
        "child_action": tree.child_action[0].cpu().numpy(),
        "child_visit": tree.child_visit[0].cpu().numpy(),
        "child_node": tree.child_node[0].cpu().numpy(),
        "root_visit": tree.root_visit[0].cpu().numpy(),
        "node_tps": [t if ok else "" for t, ok in zip(tps, live)],
    }


def main(argv=None) -> list[tuple[pathlib.Path, dict]]:
    """Write one SVG per beta; returns (path, host arrays) per beta."""
    import torch

    from ..config import NET_PRESETS
    from ..device import resolve_device
    from ..eee.harness import random_draws
    from ..models.agent import make_net_evaluate, new_agent
    from ..search.core import make_simulate
    from ..search.openings import make_new_opening
    from ..tak.engine import engine
    from ..tak.tps import tps_to_state
    from ..utils import ckpt

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--net", default="net4_rnd", choices=NET_PRESETS)
    parser.add_argument("--model", help="checkpoint path (default: fresh net)")
    parser.add_argument("--tps", default=None)
    parser.add_argument("--visits", type=int, default=1000)
    parser.add_argument("--betas", default="0,0.5,1,2,3,4")
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--max-children", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = NET_PRESETS[args.net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    bundle = new_agent(cfg, seed=0, device=dev)
    if args.model:
        bundle = ckpt.load_checkpoint(args.model, bundle)
    evaluator = make_net_evaluate(cfg, eng, device=dev)
    simulate = make_simulate(eng, lambda envs: evaluator(bundle, envs), max_depth=64)

    if args.tps:
        envs = tps_to_state(cfg.n, args.tps).map(lambda x: x[None].to(dev))
    else:
        draws = random_draws(torch.Generator(device=dev).manual_seed(0), 1, eng.num_actions)
        envs = make_new_opening(eng, random_steps=3)(**draws)

    out = []
    for beta in [float(b) for b in args.betas.split(",")]:
        host = host_arrays(search_tree(eng, simulate, envs, beta, args.visits, args.max_children), cfg.n)
        out.append((visualize(host, cfg.n, beta, args.out_dir), host))
        print(f"wrote {out[-1][0]}")
    return out


if __name__ == "__main__":
    main()
