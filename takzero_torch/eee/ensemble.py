"""EEE ensemble experiment (reference eee/src/ensemble.rs).

Counterpart of ``takzero_tpu/eee/ensemble.py``: trains the full net
(policy / value / detached UBE) plus the extra ensemble value heads on
saved targets, the heads' targets bootstrapped on-policy: for each
position, sample an action from the improved-policy target, step, and use
``-gamma * ensemble(next)`` per head, replaced by the exact negated
terminal eval when the next position is terminal (ensemble.rs:265-316).
Loss = policy CE + value MSE + UBE MSE + ensemble MSE (ensemble.rs:318-351),
one Adam over the net's and the heads' parameters together.

The heads read the train-mode core of the same forward, detached: no
second tower, and the same batch statistics as the other heads
(net4_ensemble.rs:153).  Evaluations (the bootstrap and the variances)
read the eval-mode core (``models/agent.py`` ``core_only``).  Tracked per
step: the mean per-position variance across heads on the training batch
before and after the step, and on the fixed reference batches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.target import Target
from ..device import resolve_device
from ..models.agent import core_only, new_agent
from ..models.network import NetConfig, conv_precision
from ..ops.repr import state_to_planes
from ..search import eval as ev
from ..selfplay import gumbel_noise
from ..tak.engine import engine
from ..tak.state import TakState
from ..tak.tps import tps_fields
from ..train.data import make_batch
from ..train.learner import Batch, losses_of
from .harness import REF_NAMES, reference_batches, reference_draws, unique_positions
from .rnd import to_floats, write_rows


@torch.no_grad()
def ensemble_forward(cfg: NetConfig, bundle: dict, planes: torch.Tensor) -> torch.Tensor:
    """f32[B, E]: the heads on the eval-mode core."""
    with conv_precision(cfg.compute_dtype):
        return bundle["ensemble"](core_only(cfg, bundle, planes))


def make_ensemble_optimizer(bundle: dict, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """optax's ``adam(learning_rate)`` over the net and the heads."""
    params = list(bundle["net"].parameters()) + list(bundle["ensemble"].parameters())
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_ensemble_step(cfg: NetConfig, eng):
    """Build ``step(bundle, opt, batch, states, gumbel, refs) -> metrics``
    (0-d tensors), training the bundle's net and heads in place.

    ``states`` are the batch's (augmented) positions and ``gumbel``
    f32[B, A] the noise of the bootstrap's categorical draw,
    ``argmax(log(max(p, 1e-30)) + gumbel)`` (JAX's
    ``jax.random.categorical``)."""

    def head_var(bundle, planes):
        return torch.mean(torch.var(ensemble_forward(cfg, bundle, planes), dim=-1, correction=0))

    def step(bundle: dict, opt: torch.optim.Optimizer, batch: Batch, states: TakState, gumbel, refs) -> dict:
        with torch.no_grad():
            act = (torch.log(torch.clamp(batch.policy, min=1e-30)) + gumbel).argmax(-1)
            nxt = eng.step(states, act)
            tk = eng.terminal_kind(nxt)
            bootstrap = -ev.DISCOUNT * ensemble_forward(cfg, bundle, state_to_planes(eng, nxt))
            term_val = ev.negated_float(tk, torch.zeros_like(tk), torch.zeros_like(batch.value))
            target_ens = torch.where((tk != 0)[:, None], term_val[:, None], bootstrap)
            metrics = {"current": head_var(bundle, batch.planes)}

        net, heads = bundle["net"], bundle["ensemble"]
        net.train()
        opt.zero_grad(set_to_none=False)
        with conv_precision(cfg.compute_dtype):
            policy, value, ube, core = net(batch.planes, with_core=True)
            loss, losses = losses_of(batch, policy, value, ube, True)
            loss_ens = torch.mean((target_ens - heads(core.detach())) ** 2)
            loss = loss + loss_ens
            loss.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        net.eval()
        bundle.pop("folded", None)

        metrics.update(losses, loss=loss.detach(), loss_ensemble=loss_ens.detach())
        metrics["after"] = head_var(bundle, batch.planes)
        for name in REF_NAMES:
            metrics[name] = head_var(bundle, refs[name])
        return metrics

    return step


def read_targets(n: int, target_file, take: int) -> list[Target]:
    """The first ``2 * take`` targets of the file."""
    targets: list[Target] = []
    with open(target_file, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                targets.append(Target.from_line(n, line))
            if len(targets) >= 2 * take:
                break
    return targets


def unique_positions_by_ply(n: int, targets: list[Target]) -> dict:
    """{ply: TakState[k] on the CPU}: the targets' positions of distinct TPS,
    first occurrences in file order."""
    tps = list(dict.fromkeys(t.tps for t in targets))
    if not tps:
        return {}
    fields = [tps_fields(n, x) for x in tps]
    states = TakState(**{k: torch.from_numpy(np.stack([f[k] for f in fields])) for k in TakState._fields})
    return unique_positions(states, states.ply.numpy(), tps)


def run(
    target_file,
    out_csv,
    n: int = 4,
    half_komi: int = 4,
    steps: int = 3_000,
    batch_size: int = 128,
    learning_rate: float = 1e-4,
    forced_uses: int = 4,
    ensemble_size: int = 16,
    filters: int = 256,
    blocks: int = 16,
    seed: int = 1_234_567,
    take: int = 320_000,
    log_every: int = 100,
    device=None,
    report: dict | None = None,
) -> list[dict]:
    """The experiment on ``device`` (default ``cuda``; raises without CUDA);
    stops early when a pool runs short of half a batch.  See
    :func:`takzero_torch.eee.rnd.run` for ``report``."""
    dev = resolve_device(device)
    cfg = NetConfig(n=n, half_komi=half_komi, filters=filters, blocks=blocks, novelty="ensemble",
                    ensemble_size=ensemble_size)
    eng = engine(n, half_komi=half_komi)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed % (2**31))
    bundle = new_agent(cfg, seed=seed % (2**31), device=dev)
    opt = make_ensemble_optimizer(bundle, learning_rate)
    step_fn = make_ensemble_step(cfg, eng)

    # Two forced-uses pools, as the reference splits targets.txt in half
    # (selfplay-like and reanalyze-like, ensemble.rs:43-54).
    targets = read_targets(n, target_file, take)
    half = len(targets) // 2
    pools = [[[t, forced_uses] for t in targets[:half]], [[t, forced_uses] for t in targets[half:]]]
    sources = {}
    refs = reference_batches(eng, unique_positions_by_ply(n, targets), reference_draws(gen, eng, batch_size),
                             batch_size, sources=sources)
    if report is not None:
        report.update(sources=sources, targets=len(targets))

    def one(step):
        if any(len(p) < batch_size // 2 for p in pools):
            return None
        picked = []
        for pool in pools:
            rng.shuffle(pool)
            part = pool[-batch_size // 2 :]
            del pool[-batch_size // 2 :]
            pool.extend([t, u - 1] for t, u in part if u > 1)
            picked.extend(t for t, _ in part)
        batch, states = make_batch(eng, picked, rng, return_states=True, device=dev)
        gumbel = gumbel_noise(gen, (len(picked), eng.num_actions))
        return to_floats(step_fn(bundle, opt, batch, states, gumbel, refs))

    return write_rows(out_csv, steps, one, log_every, lambda s, m: f"step {s}  loss={m['loss']:.4f}")
