"""Selfplay cells: ``SelfplayEngine.play_move``, the call
``drivers/selfplay.py`` makes each move (the search and evaluator on the
device, one readback, the host half), on every game of the batch, with the
targets and replays of finished games appended to files under ``TMPDIR``
as the actor appends them.

Set-up makes the model on the card from the configuration's weight seed
and the seen-set from the run's seed (through
``reference/net.py``'s parameter list, so that the reference and the
program hold the same tensors), the SimHash matrix and a seen-set of the
configuration's width with a share of its bits set (net6_simhash), or the
MLP RND and its normalisation bounds (net5); then it plays one move of
two candidates and two simulations on a separate engine, which builds and
loads every kernel the window runs.  The window plays whole moves until
``--seconds`` have passed; the rate is over all of them and the whole
window.  A traced run then plays one more move with the slices of the
traffic's ``slices`` profiled, counted in simulations (evaluator calls).
"""

from __future__ import annotations

import dataclasses
import json
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..harness import result, spec, stats
from ..harness.trace import Plan, SliceProfiler, Trace
from ..reference import net, search, selfplay_check, tak


def net_config(cfg: dict):
    from takzero_torch.models.network import NetConfig

    return NetConfig(
        n=cfg["n"], half_komi=cfg["half_komi"], filters=cfg["filters"], blocks=cfg["blocks"],
        novelty=cfg["novelty"], hash_bits=cfg.get("hash_bits", 32), rnd_mlp=cfg.get("rnd_mlp", False),
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
    )


def random_positions(n: int, count: int, rng: random.Random, plies=(2, 20)) -> list:
    """Positions of seeded random playouts with the reference rules."""
    out = []
    while len(out) < count:
        p = tak.initial(n)
        for _ in range(rng.randint(*plies)):
            acts = tak.legal_actions(p)
            if not acts:
                break
            p = tak.step(p, rng.choice(acts))
        out.append(p)
    return out


def build_agent(cfg: dict, seed: int, device) -> tuple:
    """(the program's agent bundle, the reference's tensors), on
    ``device``: the model (weights, SimHash matrix, RND and its bounds)
    from the configuration's ``weight_seed``, one model as a deployment
    serves one, and the seen-set's contents from ``seed``."""
    from takzero_torch.models.network import RndPair, TakNet, fold_inference_params

    gen = torch.Generator(device=device).manual_seed(cfg["weight_seed"])
    wcfg = {**cfg, **cfg["assumed"]}
    net_cfg = net_config(cfg)
    weights = {"net": net.make_params(net.net_spec(wcfg), gen, device)}
    with torch.device(device):
        model = TakNet(net_cfg)
    model.load_state_dict(weights["net"])
    model.eval()
    bundle = {"net": model, "folded": fold_inference_params(net_cfg, model)}
    if cfg["novelty"] == "simhash":
        width = net.input_channels(cfg["n"]) * cfg["n"] ** 2
        matrix = torch.randn((width, cfg["hash_bits"]), generator=gen, device=device)
        words = 1 << (cfg["hash_bits"] - 5)
        if wcfg["seen_set_density"] != 0.5:
            raise ValueError("the seen-set is drawn as uniform random words: a density of 0.5")
        seen = torch.randint(-(2**31), 2**31, (words,), dtype=torch.int32,
                             generator=torch.Generator(device=device).manual_seed(seed), device=device)
        bundle.update(hash_bits=seen, hash_matrix=matrix)
        weights.update(seen_set=seen, hash_matrix=matrix)
    elif cfg["novelty"] == "rnd" and cfg.get("rnd_mlp"):
        weights["rnd"] = net.make_params(net.rnd_spec(wcfg), gen, device)
        with torch.device(device):
            pair = RndPair(net_cfg)
        pair.load_state_dict(weights["rnd"])
        pair.eval()
        positions = random_positions(cfg["n"], 256, random.Random(cfg["weight_seed"]))
        with net.strict_float32(), torch.no_grad():
            err = net.rnd_error(weights["rnd"], net.planes(positions, cfg["half_komi"]).to(device))
        lo, hi = (float(x) for x in torch.quantile(err, torch.tensor([0.05, 0.95], device=device)))
        weights["rnd_bounds"] = (lo, hi)
        bundle.update(rnd=pair, rnd_min=torch.tensor(lo, device=device), rnd_max=torch.tensor(hi, device=device))
    else:
        raise ValueError(f"no selfplay set-up for novelty {cfg['novelty']!r}")
    return bundle, weights


def make_draws(gen: torch.Generator, batch: int, children: int) -> dict:
    """One move's random draws: Gumbel noise for the root sample and for
    the weighted-random plies, and the symmetry and corner pair of fresh
    openings."""
    dev = gen.device
    u = torch.rand((2, batch, children), generator=gen, device=dev).clamp(min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    return dict(gumbel_root=g[0], gumbel_sample=g[1],
                open_sym=torch.randint(0, 8, (batch,), generator=gen, device=dev),
                open_pair=torch.randint(0, 2, (batch,), generator=gen, device=dev))


def selfplay_config(cfg: dict, **over):
    from takzero_torch.selfplay import SelfplayConfig

    fields = dict(batch=cfg["batch"], beta=cfg["beta"], exploration=False,
                  weighted_random_plies=cfg["weighted_random_plies"], sampled_actions=cfg["sampled_actions"],
                  search_budget=cfg["search_budget"], max_children=cfg["max_children"],
                  max_depth=cfg["max_depth"], tree_reuse=cfg["tree_reuse"])
    fields.update(over)
    return SelfplayConfig(**fields)


@dataclasses.dataclass
class Played:
    moves: int = 0
    seconds: float = 0.0
    move_s: list = dataclasses.field(default_factory=list)
    searched: object = None  # the tree the last move searched (in place)
    draws: dict | None = None  # the last move's draws
    pre_visit: object = None  # the last move's root visits before its search [B, C]
    pre_expanded: object = None  # whether each root was expanded then [B]
    sims_errors: object = 0  # on the device: searches short of their simulations


def play(sp, bundle, gen, cfg, lines: Path, seconds: float | None, moves: int | None = None) -> Played:
    """Whole moves until ``seconds`` have passed (or ``moves`` are played).
    Each move's root visits are counted on the device, with no host read:
    every game's root children gain the budget, and one more on a root
    carried from the last move."""
    from takzero_torch.parallel import coordinator as co

    out = Played()
    budget = sp.cfg.search_budget
    t0 = time.perf_counter()
    while True:
        draws = make_draws(gen, cfg["batch"], cfg["max_children"])
        tree = sp.tree
        out.searched, out.draws = tree, draws
        out.pre_visit, out.pre_expanded = tree.child_visit[:, 0].clone(), tree.root_expanded()
        targets, replays, exploration = sp.play_move(bundle, draws)
        ran = tree.child_visit[:, 0].sum(-1) - out.pre_visit.sum(-1)
        out.sims_errors = out.sims_errors + (ran != budget + out.pre_expanded.to(ran.dtype)).sum()
        for name, items in ((co.TARGETS_SELFPLAY, targets), (co.REPLAYS, replays),
                            (co.REPLAYS_EXPLORATION, exploration)):
            if items:
                co.append_lines(lines, name, [x.to_line() for x in items])
        out.moves += 1
        out.move_s.append(time.perf_counter() - t0 - out.seconds)
        out.seconds = time.perf_counter() - t0
        if (seconds is not None and out.seconds >= seconds) or (moves is not None and out.moves >= moves):
            return out


def sample_nodes(n: int, t, sample: int, seed: int) -> dict:
    """Every game's root and a seeded sample of the other expanded nodes
    of the search tree ``t``: their positions, child slots and links, as
    plain arrays and reference positions."""
    b, m1, _ = t.child_visit.shape
    live = t.node_live.cpu().numpy()
    live[:, 0] = False
    live[:, m1 - 1] = False
    cand = np.argwhere(live)
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(cand), size=min(sample, len(cand)), replace=False))
    bi = np.concatenate([np.arange(b), cand[pick, 0]])
    mi = np.concatenate([np.zeros(b, np.int64), cand[pick, 1]])
    dev = t.child_visit.device
    bt, mt = torch.from_numpy(bi).to(dev), torch.from_numpy(mi).to(dev)

    def rows(x):
        return x[bt, mt].cpu().numpy()

    def positions(mrows):
        fields = [x[bt, mrows].cpu().numpy() for x in t.node_env]
        return [tak.from_fields(n, *(f[i] for f in fields)) for i in range(len(bi))]

    nodes = {k: rows(getattr(t, f"child_{k}")) for k in ("action", "logit", "prob", "visit", "flag", "ply",
                                                         "value", "std", "node")}
    pc = t.node_parent[bt, mt].clamp(min=0).to(torch.int64)
    slot = t.node_slot[bt, mt].clamp(min=0).to(torch.int64)
    def edge(x):  # the statistics of the edge into each node (garbage at the roots)
        return x[bt, pc, slot].cpu().numpy()

    nodes.update(env=positions(mt), incomplete=rows(t.node_incomplete), game=bi, is_root=mi == 0,
                 action_in=edge(t.child_action), in_visit=edge(t.child_visit), in_value=edge(t.child_value),
                 in_std=edge(t.child_std), in_flag=edge(t.child_flag),
                 parent_env=[None if m == 0 else p for m, p in zip(mi, positions(pc))])
    roots = dict(root_index=np.arange(b), root_flag=t.root_flag.cpu().numpy(), root_ply=t.root_ply.cpu().numpy(),
                 root_value=t.root_value.cpu().numpy())
    return nodes, roots


def observe(cfg: dict, sp, played: Played, sample: int, seed: int, sims_errors: int) -> dict:
    """The last move's outputs as plain arrays and reference positions."""
    nodes, roots = sample_nodes(cfg["n"], played.searched, sample, seed)
    pending, actions, history, start = [], [], [], []
    for log in sp.logs:
        if log.pending:
            last = log.pending[-1]
            pending.append({"tps": last.tps, "policy": last.policy, "ube": last.ube, "ply": last.ply})
            actions.append(log.actions[-1])
            history.append(log.actions[:-1])
        else:  # the game ended on this move: its log restarted
            pending.append(None)
            actions.append(-1)
            history.append(None)
        start.append(log.start_tps)
    roots.update(pending=pending, action=np.array(actions), history=history, start_tps=start,
                 gumbel_sample=played.draws["gumbel_sample"].cpu().numpy(),
                 gumbel_root=played.draws["gumbel_root"].cpu().numpy(),
                 pre_visit=played.pre_visit.cpu().numpy().astype(np.int64),
                 pre_expanded=played.pre_expanded.cpu().numpy())
    return dict(n=cfg["n"], C=cfg["max_children"], nodes=nodes, roots=roots, beta=cfg["beta"],
                simhash=cfg["novelty"] == "simhash", sims_errors=sims_errors, halving=True,
                sampled_actions=cfg["sampled_actions"], budget=cfg["search_budget"],
                weighted_random_plies=cfg["weighted_random_plies"],
                visitations=search.improved_policy_visitations(cfg["sampled_actions"], cfg["search_budget"]))


def check(cfg: dict, obs: dict, weights: dict, device) -> dict:
    """The program's readings against the float32 reference."""
    obs["rules_errors"] = selfplay_check.rules_errors(obs)
    legal = selfplay_check.legal_sets(obs["nodes"]["env"])
    ref = net.evaluate(cfg, weights, obs["nodes"]["env"], device)
    return selfplay_check.readings(obs, legal, ref, selfplay_check.program_outputs(obs))


@dataclasses.dataclass
class Session:
    """One set-up, window and (traced) slice move of a selfplay cell, and
    the last move's outputs for the check."""

    setup_s: float
    moves: int
    window_s: float
    move_s: list
    sims: int
    peak: int
    obs: dict
    weights: dict
    trace: Trace | None


def session(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
            device="cuda", t_start=None) -> Session:
    from takzero_torch.models.agent import make_net_evaluate
    from takzero_torch.selfplay import SelfplayEngine
    from takzero_torch.tak.engine import engine as tak_engine

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    lines = Path(tempfile.gettempdir()) / "takzero-benchmark" / cell["name"] / traffic["lines_dir"]
    shutil.rmtree(lines, ignore_errors=True)
    lines.mkdir(parents=True)

    bundle, weights = build_agent(cfg, seed, dev)
    eng = tak_engine(cfg["n"], half_komi=cfg["half_komi"])
    evaluate = make_net_evaluate(net_config(cfg), eng, device=dev)
    hook = {"profiler": None}

    def evaluator(agent, envs):
        if hook["profiler"] is not None:
            hook["profiler"].tick()
        return evaluate(agent, envs)

    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5E1F)
    warm = SelfplayEngine(eng, selfplay_config(cfg, **traffic["warmup"]), evaluate, device=dev)
    warm.reset(make_draws(gen, cfg["batch"], cfg["max_children"]))
    play(warm, bundle, gen, cfg, lines, None, moves=1)
    del warm
    sp = SelfplayEngine(eng, selfplay_config(cfg), evaluator if traced else evaluate, device=dev)
    sp.reset(make_draws(gen, cfg["batch"], cfg["max_children"]))
    sync()
    setup_s = time.perf_counter() - t_start

    window = play(sp, bundle, gen, cfg, lines, seconds)
    sims = stats.selfplay_sims(cfg["search_budget"], cfg["batch"], window.moves)
    trace, played = None, window
    if traced:
        plans = [Plan(name, s["start"], s["units"], name == "host") for name, s in traffic["slices"].items()]
        hook["profiler"] = SliceProfiler(plans, sync)
        played = play(sp, bundle, gen, cfg, lines, None, moves=1)
        hook["profiler"].finish()
        width = net.input_channels(cfg["n"]) * cfg["n"] ** 2
        trace = Trace(
            cell=cell["name"], cfg=cfg, traffic=traffic, slices=hook["profiler"].slices,
            window={"units": window.moves * (cfg["search_budget"] + 1), "seconds": window.seconds,
                    "traced_move_s": played.seconds},
            counts={"evaluated_rows": sims},
            shapes={"topk": (cfg["batch"], net.num_actions(cfg["n"]), cfg["max_children"]),
                    "simhash": (cfg["batch"], width, cfg["hash_bits"]) if cfg["novelty"] == "simhash" else None},
        )
        hook["profiler"] = None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    sims_errors = int(window.sims_errors) + (int(played.sims_errors) if traced else 0)
    obs = observe(cfg, sp, played, traffic["check_nodes"], seed, sims_errors)
    out = Session(setup_s, window.moves, window.seconds, window.move_s, sims, peak, obs, weights, trace)
    del sp, bundle, played, window
    if on_card:
        torch.cuda.empty_cache()
    return out


def control_readings(cfg: dict, obs: dict, weights: dict, device) -> dict:
    """The readings of the control: the reference in float8, put in the
    program's place."""
    legal = selfplay_check.legal_sets(obs["nodes"]["env"])
    ref = net.evaluate(cfg, weights, obs["nodes"]["env"], device)
    low = net.evaluate(cfg, weights, obs["nodes"]["env"], device, q=net.fp8)
    return selfplay_check.readings(obs, legal, ref, selfplay_check.reference_outputs_in_place(obs, low))


def run(bench: dict, cell: dict, cfg: dict, traffic: dict, args, device="cuda", t_start=None, limits=None) -> dict:
    s = session(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), device, t_start)
    t_check = time.perf_counter()
    values = check(cfg, s.obs, s.weights, torch.device(device))
    print(f"check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct, checks = result.judge(values, limits or spec.limits(cell["name"]))
    print(f"selfplay check: {values['_nodes']} nodes, logit rms {values['_logit_rms']:.4f}, "
          f"{values['_roots_unchecked']} roots not checked", file=sys.stderr)
    print(f"window: {s.moves} moves in {s.window_s:.3f} s ({', '.join(f'{t:.2f}' for t in s.move_s)} s each); "
          f"set-up {s.setup_s:.3f} s", file=sys.stderr)
    print("readings: " + json.dumps(values), file=sys.stderr)
    e2e = {"setup_s": s.setup_s, "selfplay_sims_per_s": stats.rate(s.sims, s.window_s)}
    return result.outcome(bench, cell, e2e, s.trace, s.peak, correct, checks,
                          attempted=s.moves * cfg["batch"], failed=0, on_card=torch.device(device).type == "cuda")


def calibrate(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, control: bool = True,
              device="cuda") -> tuple:
    """(program readings, control readings or None) of one seed."""
    s = session(cell, cfg, traffic, seed, seconds, False, device)
    dev = torch.device(device)
    prog = check(cfg, s.obs, s.weights, dev)
    prog["_moves"], prog["_sims_per_s"] = s.moves, stats.rate(s.sims, s.window_s)
    return prog, (control_readings(cfg, s.obs, s.weights, dev) if control else None)
