"""EEE RND experiment (reference eee/src/rnd.rs).

Counterpart of ``takzero_tpu/eee/rnd.py``: trains a standalone RND
predictor against its frozen target on replay positions (Adam 1e-4, batch
256, forced-uses-4 buffer; rnd.rs:24-28) and tracks the *normalized
surprise* -- per-position squared predictor error, scaled by
MAXIMUM_VARIANCE / std(train-batch error) -- on fixed held-out batches:
current/after (the training batch before/after the step), early, late,
random_early, random_late, impossible_early.  Appends one CSV row per step
in the reference's column layout (rnd.rs:322-340).

As in JAX, every error is the per-position feature-summed squared error
(the quantity ``normalized_rnd`` uses), early and late included.  The
predictor trains in place: ``current`` is read in eval mode before the
step, the step runs in train mode (batch statistics), ``after`` and the
reference batches are read in eval mode after it.  The target stays
frozen and in eval mode (``models/network.py`` ``RndPair``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.network import MAXIMUM_VARIANCE, NetConfig, RndPair, conv_precision, init_rnd
from ..tak.engine import engine
from .harness import REF_NAMES, ForcedUsesBuffer, load_replay_positions, planes_of, reference_batches, reference_draws

CSV_HEADER = "step,current,after,early,late,random_early,random_late,impossible_early"


def csv_row(step: int, m: dict) -> str:
    return (f"{step},{m['current']},{m['after']},{m['early']},{m['late']},"
            f"{m['random_early']},{m['random_late']},{m['impossible_early']}\n")


def to_floats(metrics: dict) -> dict:
    """0-d device tensors -> Python floats, with one readback."""
    return dict(zip(metrics, torch.stack([v.float() for v in metrics.values()]).tolist()))


def write_rows(out_csv, steps: int, step_fn, log_every: int, line) -> list[dict]:
    """The experiments' loop: ``step_fn(step)`` -> metrics (floats), or None
    to stop early; one CSV row per step after the header, flushed and
    logged (``line(step, m)``) every ``log_every`` steps."""
    rows = []
    with open(out_csv, "w", encoding="utf-8") as f:
        f.write(CSV_HEADER + "\n")
        for step in range(steps):
            m = step_fn(step)
            if m is None:
                break
            rows.append(m)
            f.write(csv_row(step, m))
            if step % log_every == 0:
                f.flush()
                print(line(step, m))
    return rows


def make_rnd_optimizer(rnd: RndPair, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """optax's ``adam(learning_rate)`` over the predictor (the target's
    gradient is zero in JAX, so its update is exactly zero there)."""
    return torch.optim.Adam(rnd.predictor.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_rnd_step(cfg: NetConfig):
    """Build ``step(rnd, opt, train_planes, refs) -> metrics`` (0-d tensors),
    training ``rnd``'s predictor in place."""

    @torch.no_grad()
    def err(rnd: RndPair, planes):
        with conv_precision(cfg.compute_dtype):
            return rnd(planes)

    def step(rnd: RndPair, opt: torch.optim.Optimizer, train_planes, refs) -> dict:
        current = err(rnd, train_planes)
        # jnp.std is the population deviation.
        scale = MAXIMUM_VARIANCE / torch.clamp(torch.std(current, correction=0), min=1e-8)
        rnd.train()
        opt.zero_grad(set_to_none=False)
        with conv_precision(cfg.compute_dtype):
            loss = torch.mean(rnd(train_planes))
            loss.backward()
        opt.step()
        rnd.eval()
        metrics = {"current": torch.mean(current) * scale, "loss": loss.detach()}
        metrics["after"] = torch.mean(err(rnd, train_planes)) * scale
        for name in REF_NAMES:
            metrics[name] = torch.mean(err(rnd, refs[name])) * scale
        return metrics

    return step


def run(
    replay_file,
    out_csv,
    n: int = 4,
    half_komi: int = 4,
    steps: int = 45_000,
    batch_size: int = 256,
    learning_rate: float = 1e-4,
    forced_uses: int = 4,
    seed: int = 432,
    log_every: int = 100,
    rnd_mlp: bool = False,
    device=None,
    report: dict | None = None,
) -> list[dict]:
    """The experiment on ``device`` (default ``cuda``; raises without CUDA).
    Returns the metrics of each step; ``report``, if given, receives where
    the reference batches came from and the stream's size."""
    dev = resolve_device(device)
    cfg = NetConfig(n=n, half_komi=half_komi, novelty="rnd", rnd_mlp=rnd_mlp)
    eng = engine(n, half_komi=half_komi)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = init_rnd(cfg, seed).to(dev)
    opt = make_rnd_optimizer(rnd, learning_rate)
    step_fn = make_rnd_step(cfg)

    positions, unique_by_ply = load_replay_positions(eng, replay_file, dev, limit=steps * batch_size // 10)
    sources = {}
    refs = reference_batches(eng, unique_by_ply, reference_draws(gen, eng, batch_size), batch_size, sources=sources)
    if report is not None:
        report.update(sources=sources, positions=int(positions.ply.shape[0]))
    buffer = ForcedUsesBuffer(positions.ply.shape[0], rng, batch_size, forced_uses)
    positions = positions.map(lambda x: x.to(dev))

    def one(step):
        idx = torch.from_numpy(buffer.take()).to(dev)
        planes = planes_of(eng, positions.map(lambda x: x[idx]))
        return to_floats(step_fn(rnd, opt, planes, refs))

    return write_rows(out_csv, steps, one, log_every, lambda s, m: f"step: {s:>8}  loss={m['loss']:.4f}")
