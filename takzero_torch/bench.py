"""Benchmark: MCTS simulations/second of the port's selfplay move program.

Counterpart of the root ``bench.py``: the same configuration (6x6, 128
parallel games, Gumbel sequential halving k=64, budget 768, 256 child
slots, tree reuse, a 16x256 ResNet in bf16 with SimHash novelty over 2^26
bits, random weights from seed 0), the same ``TAKZERO_BENCH_*`` overrides
and the same one-line JSON, measured on the CUDA card:

    python -m takzero_torch.bench

It times ``SelfplayEngine.move``, the program a selfplay actor runs each
move, including the packed int32 buffer's copy to the host.  Env
overrides: TAKZERO_BENCH_BATCH, TAKZERO_BENCH_BUDGET,
TAKZERO_BENCH_SAMPLED, TAKZERO_BENCH_MOVES, TAKZERO_BENCH_FILTERS,
TAKZERO_BENCH_BLOCKS, TAKZERO_BENCH_CHILDREN, TAKZERO_BENCH_REUSE (0
disables tree reuse), TAKZERO_BENCH_VERBOSE (1: per-move seconds on
stderr), TAKZERO_BENCH_CKPT (a checkpoint of the port's learner or a
JAX run's, ``takzero_torch/utils/ckpt.py``: its weights, SimHash matrix
and, for a step checkpoint, seen-set replace the random ones; the
SimHash width is the checkpoint's, and its filters and blocks must match
TAKZERO_BENCH_FILTERS and TAKZERO_BENCH_BLOCKS).

``vs_baseline`` divides by ``reference_on_this_host_sims_per_s_total`` in
``BASELINE.json``, as the root bench does; that anchor was measured on the
CPU of another host, not on the card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass(frozen=True)
class BenchConfig:
    batch: int = 128
    budget: int = 768
    sampled: int = 64
    moves: int = 2
    filters: int = 256
    blocks: int = 16
    children: int | None = None  # None: the preset's (256 at 6x6)
    reuse: bool = True
    hash_bits: int = 26
    seed: int = 0
    ckpt: str | None = None

    @classmethod
    def from_env(cls) -> "BenchConfig":
        env = os.environ.get
        children = env("TAKZERO_BENCH_CHILDREN")
        return cls(
            batch=int(env("TAKZERO_BENCH_BATCH", 128)),
            budget=int(env("TAKZERO_BENCH_BUDGET", 768)),
            sampled=int(env("TAKZERO_BENCH_SAMPLED", 64)),
            moves=int(env("TAKZERO_BENCH_MOVES", 2)),
            filters=int(env("TAKZERO_BENCH_FILTERS", 256)),
            blocks=int(env("TAKZERO_BENCH_BLOCKS", 16)),
            children=int(children) if children else None,
            reuse=env("TAKZERO_BENCH_REUSE", "1") != "0",
            ckpt=env("TAKZERO_BENCH_CKPT") or None,
        )


@dataclass
class BenchResult:
    cfg: BenchConfig
    max_children: int
    device_name: str
    warmup_s: float
    per_move_s: list = field(default_factory=list)
    # The last timed move, for callers that check it.
    envs_before: object = None
    envs_after: object = None
    tree: object = None
    packed: torch.Tensor | None = None

    @property
    def sims_per_s(self) -> float:
        sims_per_move = (self.cfg.budget + 1) * self.cfg.batch  # +1 root-init sim
        return sims_per_move * len(self.per_move_s) / sum(self.per_move_s)

    def json_line(self) -> dict:
        c = self.cfg
        vs_baseline = 1.0
        try:
            baseline = json.loads((Path(__file__).resolve().parents[1] / "BASELINE.json").read_text())
            anchor = baseline["published"]["reference_on_this_host_sims_per_s_total"]
            vs_baseline = round(self.sims_per_s / anchor, 2)
        except (OSError, KeyError, ValueError):
            pass
        return {
            "metric": "mcts_sims_per_s_selfplay_6x6",
            "value": round(self.sims_per_s, 1),
            "unit": (
                f"simulations/s (batch={c.batch}, k={c.sampled}, budget={c.budget}, "
                f"{c.blocks}x{c.filters} net, C={self.max_children}, reuse={int(c.reuse)}, "
                f"{'trained ckpt' if c.ckpt else 'random init'}; full selfplay move program; "
                f"takzero_torch on {self.device_name})"
            ),
            "vs_baseline": vs_baseline,
        }


@dataclass
class Setup:
    """The objects of one bench run: engine, agent, selfplay engine, the
    draw generator and the games' current envs and trees."""

    eng: object
    agent: dict
    sp: object
    gen: torch.Generator
    envs: object
    tree: object

    @property
    def children(self) -> int:
        return self.sp.cfg.max_children

    def move(self):
        """One move of every game; returns ``(envs_before, packed_on_host)``."""
        from .selfplay import make_draws

        draws = make_draws(self.gen, self.sp.cfg.batch, self.children)
        before = self.envs
        self.envs, self.tree, packed, _ = self.sp.move(self.envs, self.tree, self.agent, draws)
        return before, packed.cpu()  # the actor's one readback per move


def setup(cfg: BenchConfig, device=None) -> Setup:
    """Random weights from ``cfg.seed`` (or ``cfg.ckpt``'s), fresh openings
    and fresh trees."""
    from .config import selfplay_preset
    from .device import resolve_device
    from .models.agent import make_net_evaluate, new_agent
    from .models.network import NetConfig
    from .selfplay import SelfplayEngine, make_draws
    from .tak.engine import engine
    from .utils import ckpt

    dev = resolve_device(device)
    hash_bits = cfg.hash_bits
    if cfg.ckpt:
        hash_bits = ckpt.read_checkpoint(cfg.ckpt)["hash_matrix"].shape[1]
    net_cfg = NetConfig(
        n=6, half_komi=4, filters=cfg.filters, blocks=cfg.blocks,
        novelty="simhash", hash_bits=hash_bits,
    )
    eng = engine(6, half_komi=4)
    agent = new_agent(net_cfg, seed=cfg.seed, device=dev)
    if cfg.ckpt:
        ckpt.load_checkpoint(cfg.ckpt, agent)
    evaluator = make_net_evaluate(net_cfg, eng, device=dev)
    overrides = dict(
        batch=cfg.batch, search_budget=cfg.budget, sampled_actions=cfg.sampled,
        tree_reuse=cfg.reuse,
    )
    if cfg.children:
        overrides["max_children"] = cfg.children
    sp = SelfplayEngine(eng, selfplay_preset("net6_simhash", **overrides), evaluator, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    sp.reset(make_draws(gen, cfg.batch, sp.cfg.max_children))
    return Setup(eng, agent, sp, gen, sp.envs, sp.tree)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: BenchConfig, device=None) -> BenchResult:
    """One warm-up move, then ``cfg.moves`` timed moves on ``device``."""
    st = setup(cfg, device)
    dev = st.sp.device
    _sync(dev)
    t0 = time.perf_counter()
    st.move()
    res = BenchResult(
        cfg, st.children,
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        time.perf_counter() - t0,
    )
    for _ in range(cfg.moves):
        _sync(dev)
        t1 = time.perf_counter()
        res.envs_before, res.packed = st.move()
        res.per_move_s.append(time.perf_counter() - t1)
    res.envs_after, res.tree = st.envs, st.tree
    return res


def main() -> None:
    cfg = BenchConfig.from_env()
    res = run(cfg)
    if os.environ.get("TAKZERO_BENCH_VERBOSE", "0") != "0":
        print("per-move s: " + " ".join(f"{t:.3f}" for t in res.per_move_s), file=sys.stderr)
    print(json.dumps(res.json_line()))


if __name__ == "__main__":
    sys.exit(main())
