"""EEE hash-novelty generalization experiment (eee/src/generalization.rs).

Counterpart of ``takzero_tpu/eee/generalization.py``: the RND experiment's
harness, but the "estimator" is a SimHash or LCG-hash count bitset.  Each
step marks a replay-position batch as seen and records the mean novelty
(0..MAXIMUM_VARIANCE) of the training batch before and after, and of the
fixed reference batches.  Only the hash state exists here (no network), as
in JAX's bundle.  Under SimHash each step runs kernel B 8 times: for
``current``, the update, ``after`` and the 5 reference batches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.agent import hash_novelty, hash_update, new_hash_state
from ..models.network import NetConfig
from ..tak.engine import engine
from .harness import REF_NAMES, ForcedUsesBuffer, load_replay_positions, planes_of, reference_batches, reference_draws
from .rnd import to_floats, write_rows


def make_hash_step(cfg: NetConfig):
    """Build ``step(state, train_planes, refs) -> (state, metrics)``; the
    seen-set of ``state`` is updated in place."""

    def step(state: dict, train_planes, refs):
        metrics = {"current": torch.mean(hash_novelty(cfg, state, train_planes))}
        state = hash_update(cfg, state, train_planes)
        metrics["after"] = torch.mean(hash_novelty(cfg, state, train_planes))
        for name in REF_NAMES:
            metrics[name] = torch.mean(hash_novelty(cfg, state, refs[name]))
        return state, metrics

    return step


def run(
    replay_file,
    out_csv,
    n: int = 4,
    half_komi: int = 4,
    novelty: str = "simhash",
    hash_bits: int = 26,
    steps: int = 45_000,
    batch_size: int = 256,
    forced_uses: int = 4,
    seed: int = 432,
    log_every: int = 100,
    device=None,
    report: dict | None = None,
) -> list[dict]:
    """The experiment on ``device`` (default ``cuda``; raises without CUDA);
    see :func:`takzero_torch.eee.rnd.run` for ``report``."""
    if novelty not in ("simhash", "lcghash"):
        raise ValueError(f"generalization: novelty must be simhash or lcghash, got {novelty!r}")
    dev = resolve_device(device)
    cfg = NetConfig(n=n, half_komi=half_komi, novelty=novelty, hash_bits=hash_bits)
    eng = engine(n, half_komi=half_komi)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = new_hash_state(cfg, seed, dev)
    step_fn = make_hash_step(cfg)

    positions, unique_by_ply = load_replay_positions(eng, replay_file, dev, limit=steps * batch_size // 10)
    sources = {}
    refs = reference_batches(eng, unique_by_ply, reference_draws(gen, eng, batch_size), batch_size, sources=sources)
    if report is not None:
        report.update(sources=sources, positions=int(positions.ply.shape[0]))
    buffer = ForcedUsesBuffer(positions.ply.shape[0], rng, batch_size, forced_uses)
    positions = positions.map(lambda x: x.to(dev))

    def one(step):
        idx = torch.from_numpy(buffer.take()).to(dev)
        _, metrics = step_fn(state, planes_of(eng, positions.map(lambda x: x[idx])), refs)
        return to_floats(metrics)

    return write_rows(out_csv, steps, one, log_every, lambda s, m: f"step: {s:>8}")
