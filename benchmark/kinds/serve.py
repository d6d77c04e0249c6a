"""Serve cells: ``drivers/tei.py``'s ``TeiEngine.handle`` on the command
lines a match runner sends: for every ply ``position startpos moves ...``
then ``go nodes N``, the bestmove played, with the engine's tree reuse.
Games start from two seeded placements and restart at a terminal
position or at the traffic's last ply.  A ``go``'s latency runs from
handing the engine the line to its ``bestmove``.

Set-up makes the model on the card from the configuration's weight seed
and the seen-set from the run's seed (as the selfplay cells do), hands
them to the engine in
place of its own, and plays one ``go`` of the cell's size.  The window
sends commands until ``--seconds`` have passed, and ends on a whole
``go``.  A traced run then plays more plies with the traffic's ``slices``
profiled, counted in ``go`` commands.
"""

from __future__ import annotations

import dataclasses
import json
import random
import sys
import time

import numpy as np
import torch

from ..harness import result, spec, stats
from ..harness.trace import Plan, SliceProfiler, Trace
from ..reference import net, search, selfplay_check, tak
from .selfplay import build_agent, sample_nodes


class Sink:
    """The engine's standard output: keeps the lines it prints."""

    def __init__(self):
        self.lines: list = []

    def write(self, text: str) -> int:
        self.lines += [x for x in text.splitlines() if x]
        return len(text)

    def flush(self) -> None:
        pass


@dataclasses.dataclass
class Match:
    """The match runner's side: the game being played and every answer."""

    n: int
    rng: random.Random
    max_ply: int
    moves: list = dataclasses.field(default_factory=list)
    position: tak.Position | None = None
    gos: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    illegal: int = 0
    sims_errors: object = 0  # on the device: gos whose root did not gain its nodes

    def new_game(self) -> None:
        self.position, self.moves = tak.initial(self.n), []
        for _ in range(2):
            a = self.rng.choice(tak.legal_actions(self.position))
            self.moves.append(a)
            self.position = tak.step(self.position, a)


def play_ply(eng, sink: Sink, match: Match, nodes: int, tick=None) -> None:
    """One ``position`` and one ``go``; the bestmove is played or, where
    the game is over, a new one begins."""
    if match.position is None or tak.game_over(match.position) or match.position.ply >= match.max_ply:
        eng.handle("teinewgame")
        match.new_game()
    eng.handle("position startpos moves " + " ".join(tak.ptn(match.n, a) for a in match.moves))
    if tick is not None:
        tick()
    tree = eng.tree  # None, or the tree the go searches in place
    if tree is not None:
        pre_root, pre_children = tree.root_visit.clone(), tree.child_visit[:, 0].sum(-1)
        pre_expanded = tree.root_expanded().to(pre_root.dtype)
    t0 = time.perf_counter()
    eng.handle(f"go nodes {nodes}")
    match.latencies.append(time.perf_counter() - t0)
    match.gos += 1
    # Each simulation adds a root visit, and a root child's visit unless it
    # expands an unexpanded root; counted on the device, with no host read.
    if eng.tree is None:  # answered without a search
        match.sims_errors = match.sims_errors + 1
    else:
        if tree is not eng.tree:  # a fresh tree
            tree, pre_root, pre_children, pre_expanded = eng.tree, 0, 0, 0
        gained = tree.child_visit[:, 0].sum(-1) - pre_children
        match.sims_errors = match.sims_errors + ((tree.root_visit - pre_root != nodes)
                                                 | (gained != nodes - 1 + pre_expanded)).sum()
    best = [x for x in sink.lines if x.startswith("bestmove")][-1].split()[1]
    sink.lines.clear()
    try:
        a = tak.parse_ptn(match.n, best)
    except (ValueError, IndexError):
        a = -1
    if a not in tak.legal_actions(match.position):
        match.illegal += 1
        match.position = None  # the game cannot go on
        return
    match.moves.append(a)
    match.position = tak.step(match.position, a)


@dataclasses.dataclass
class Session:
    setup_s: float
    window_s: float
    gos: int
    latencies: list
    illegal: int
    peak: int
    obs: dict
    weights: dict
    trace: Trace | None


def session(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
            device="cuda", t_start=None) -> Session:
    from takzero_torch.config import NET_PRESETS
    from takzero_torch.drivers.tei import TeiEngine

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    preset = NET_PRESETS[traffic["engine_net"]]
    for key in ("n", "half_komi", "filters", "blocks", "novelty", "hash_bits"):
        if getattr(preset, key) != cfg[key]:
            raise ValueError(f"the engine's preset {traffic['engine_net']} has {key}={getattr(preset, key)}, "
                             f"the configuration {cfg[key]}")
    bundle, weights = build_agent(cfg, seed, dev)
    sink = Sink()
    eng = TeiEngine(traffic["engine_net"], None, out=sink, device=dev)
    eng.bundle = bundle  # the benchmark's weights in place of the engine's own
    for line in ("tei", "isready"):
        eng.handle(line)
    nodes = traffic["go_nodes"]
    warm = Match(cfg["n"], random.Random(seed ^ 0x7E1), traffic["max_ply"])
    play_ply(eng, sink, warm, nodes)
    eng.handle("teinewgame")
    match = Match(cfg["n"], random.Random(seed), traffic["max_ply"])
    sync()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        play_ply(eng, sink, match, nodes)
    window_s = time.perf_counter() - t0
    gos, latencies = match.gos, list(match.latencies)
    trace = None
    if traced:
        plans = [Plan(name, s["start"], s["units"], name == "host") for name, s in traffic["slices"].items()]
        prof = SliceProfiler(plans, sync)
        for _ in range(max(p.start + p.units for p in plans) + 1):
            play_ply(eng, sink, match, nodes, tick=prof.tick)
        prof.finish()
        trace = Trace(cell=cell["name"], cfg=cfg, traffic=traffic, slices=prof.slices,
                      window={"units": gos, "seconds": window_s}, counts={"evaluated_rows": gos * nodes})
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    obs = observe(cfg, eng, match, traffic["check_nodes"], seed)
    out = Session(setup_s, window_s, gos, latencies, match.illegal, peak, obs, weights, trace)
    del eng, bundle
    if on_card:
        torch.cuda.empty_cache()
    return out


def observe(cfg: dict, eng, match: Match, sample: int, seed: int) -> dict:
    """The last ``go``'s tree and answer, and the game's moves before it."""
    nodes, roots = sample_nodes(cfg["n"], eng.tree, sample, seed)
    answered = match.moves[-1] if match.position is not None else -1
    roots.update(pending=[None], action=np.array([answered]), history=[match.moves[:-1]],
                 start_tps=[tak.to_tps(tak.initial(cfg["n"]))], gumbel_sample=None)
    return dict(n=cfg["n"], C=eng.tree.max_children, nodes=nodes, roots=roots, beta=0.0,
                simhash=cfg["novelty"] == "simhash", sims_errors=int(match.sims_errors),
                weighted_random_plies=0, visitations=0.0, illegal_answers=match.illegal)


def check(cfg: dict, obs: dict, weights: dict, device, q=None) -> dict:
    obs["rules_errors"] = selfplay_check.rules_errors(obs)
    legal = selfplay_check.legal_sets(obs["nodes"]["env"])
    ref = net.evaluate(cfg, weights, obs["nodes"]["env"], device)
    out = selfplay_check.program_outputs(obs)
    if q is not None:
        out = selfplay_check.reference_outputs_in_place(obs, net.evaluate(cfg, weights, obs["nodes"]["env"], device, q=q))
    values = selfplay_check.readings(obs, legal, ref, out)
    root = selfplay_check._root(obs, 0)
    values["bestmove_errors"] = obs["illegal_answers"] + int(root["action"][search.best_slot(root)] != obs["roots"]["action"][0])
    for k in ("policy_err", "ube_err", "action_errors", "_roots_unchecked"):
        values.pop(k)
    return values


def run(bench: dict, cell: dict, cfg: dict, traffic: dict, args, device="cuda", t_start=None, limits=None) -> dict:
    s = session(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), device, t_start)
    values = check(cfg, s.obs, s.weights, torch.device(device))
    correct, checks = result.judge(values, limits or spec.limits(cell["name"]))
    p90 = stats.percentile(s.latencies, 90)
    print(f"window: {s.gos} go commands in {s.window_s:.3f} s, p90 {p90:.4f} s over {len(s.latencies)} "
          f"(median {stats.percentile(s.latencies, 50):.4f}); set-up {s.setup_s:.3f} s", file=sys.stderr)
    print("readings: " + json.dumps(values), file=sys.stderr)
    e2e = {"setup_s": s.setup_s, "serve_nodes_per_s": stats.rate(s.gos * traffic["go_nodes"], s.window_s),
           "serve_go_p90_s": p90}
    return result.outcome(bench, cell, e2e, s.trace, s.peak, correct, checks, attempted=s.gos,
                          failed=s.illegal, on_card=torch.device(device).type == "cuda")


def calibrate(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, control: bool = True,
              device="cuda") -> tuple:
    s = session(cell, cfg, traffic, seed, seconds, False, device)
    dev = torch.device(device)
    prog = check(cfg, s.obs, s.weights, dev)
    prog["_gos"], prog["_p90_s"] = s.gos, stats.percentile(s.latencies, 90)
    return prog, (check(cfg, s.obs, s.weights, dev, q=net.fp8) if control else None)
