"""Interactive analysis REPL.

Counterpart of ``takzero_tpu/drivers/analysis.py`` (analysis/src/main.rs):
enter a move to play it; enter anything else to run a chunk of simulations
and print the root action table (visits, logit, probability, improved
policy, q, std-dev, eval), the debugging view of the reference's
node/debug.rs.  A chunk is one plain ``simulate`` and one
``simulate_batch`` of ``SIM_CHUNK - 1`` simulations (one network call).

Usage: python -m takzero_torch.drivers.analysis [--net ...] [--model CKPT]
           [--tps "..."] [--example] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import NET_PRESETS
from ..device import resolve_device
from ..models.agent import make_net_evaluate, new_agent
from ..search import eval as ev
from ..search.core import make_kernels
from ..search.policy import improved_policy, select_best_slot, slot_action
from ..search.tree import init_tree
from ..tak.engine import engine
from ..tak.moves import action_to_ptn, ptn_to_action
from ..tak.tps import state_to_tps, tps_to_state
from ..utils import ckpt
from . import refuse_unported

SIM_CHUNK = 128
MAX_NODES = 1 << 13


def eval_str(flag, ply, value) -> str:
    if flag == ev.WIN:
        return f"Win({ply})"
    if flag == ev.LOSS:
        return f"Loss({ply})"
    if flag == ev.DRAW:
        return f"Draw({ply})"
    return f"{value:+.4f}"


def print_root_table(n, tree, out=None):
    """The root's statistics and one row per valid root child, most visited
    first (tree lane 0), to ``out`` (default: the current ``sys.stdout``)."""
    out = sys.stdout if out is None else out
    row = {f: getattr(tree, f)[0, 0] for f in
           ("child_action", "child_visit", "child_logit", "child_prob", "child_flag", "child_ply",
            "child_value", "child_std")}
    q = ev.negated_float(row["child_flag"], row["child_ply"], row["child_value"])
    pol = improved_policy(tree, float(row["child_visit"].max()))[0]
    host = {k: v.cpu().numpy() for k, v in row.items()}
    q, pol = q.cpu().numpy(), pol.cpu().numpy()
    order = (-host["child_visit"]).argsort()  # numpy's default kind, as JAX's table
    root = {f: getattr(tree, f)[0].item() for f in ("root_visit", "root_flag", "root_ply", "root_value", "root_std")}
    print(
        f"root: visits={root['root_visit']} "
        f"eval={eval_str(root['root_flag'], root['root_ply'], root['root_value'])} "
        f"std={root['root_std']:.4f}",
        file=out,
    )
    print(f"{'move':>8} {'visits':>7} {'logit':>8} {'prob':>7} {'improved':>9} {'q':>8} {'std':>7} {'eval':>10}",
          file=out)
    for slot in order:
        a = int(host["child_action"][slot])
        if a < 0:
            continue
        flag, ply = int(host["child_flag"][slot]), int(host["child_ply"][slot])
        print(
            f"{action_to_ptn(n, a):>8}"
            f" {int(host['child_visit'][slot]):>7}"
            f" {float(host['child_logit'][slot]):>8.3f}"
            f" {float(host['child_prob'][slot]):>7.4f}"
            f" {pol[slot]:>9.4f}"
            f" {float(q[slot]):>8.4f}"
            f" {float(host['child_std'][slot]):>7.4f}"
            f" {eval_str(flag, ply, float(host['child_value'][slot])):>10}",
            file=out,
        )


def make_chunk_runner(cfg, eng, bundle, device):
    """``run_chunk(tree) -> tree``: one ``simulate`` then one
    ``simulate_batch`` of SIM_CHUNK-1 simulations (one network call)."""
    evaluator = make_net_evaluate(cfg, eng, device=device)
    simulate, simulate_batch = make_kernels(eng, lambda e: evaluator(bundle, e), max_depth=64)

    def run_chunk(tree):
        return simulate_batch(simulate(tree, 0.0), 0.0, SIM_CHUNK - 1)

    return run_chunk


def fresh_tree(cfg, eng, state):
    """A fresh tree for one position (a batch of 1)."""
    return init_tree(eng, state, MAX_NODES, 256 if cfg.n >= 6 else 128)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--model", default=None)
    parser.add_argument("--tps", default=None)
    parser.add_argument("--example", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None, help="refused: this driver runs on one device")
    args = parser.parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(args.device)

    cfg = NET_PRESETS[args.net]
    eng = engine(cfg.n, half_komi=cfg.half_komi)
    bundle = new_agent(cfg, seed=0, device=dev)
    if args.model:
        ckpt.load_checkpoint_partial(args.model, bundle)
    run = make_chunk_runner(cfg, eng, bundle, dev)
    if args.tps:
        state = tps_to_state(cfg.n, args.tps).map(lambda x: x[None].to(dev))
    else:
        state = eng.initial(1, dev)

    def play(state, action: int):
        return eng.step(state, torch.tensor([action], device=dev))

    def tps(state) -> str:
        return state_to_tps(cfg.n, state.map(lambda x: x[0].cpu()))

    tree = fresh_tree(cfg, eng, state)
    if args.example:
        for _ in range(8):
            tree = run(tree)
            print_root_table(cfg.n, tree)
            action = int(slot_action(tree, select_best_slot(tree))[0])
            print(f"playing {action_to_ptn(cfg.n, action)}")
            state = play(state, action)
            print(tps(state))
            if int(eng.game_result(state)[0]) != -1:
                break
            tree = fresh_tree(cfg, eng, state)
        return

    print(tps(state))
    for line in sys.stdin:
        line = line.strip()
        if line in ("quit", "exit"):
            break
        try:
            action = ptn_to_action(cfg.n, line)
            if not bool(eng.legal_mask(state)[0, action]):
                print("illegal move")
                continue
            state = play(state, action)
            tree = fresh_tree(cfg, eng, state)
            print(tps(state))
        except ValueError:
            tree = run(tree)
            print_root_table(cfg.n, tree)


if __name__ == "__main__":
    main()
