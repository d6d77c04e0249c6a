"""What the pool-size tools share (``pool_cliff``, ``phase_cliff``,
``op_cliff``, ``rw_cliff``, ``scatter_variants``, ``slope_trace``).

The JAX package's tools answer one question with XLA's compiler: does the
cost of a simulation grow with the tree pool's size M, though every op
reads or writes rows of it?  The port answers it on the card: each tool
times its loop with CUDA events after a warm-up, and where JAX reads the
compiler (``cost_analysis()``, HLO text) the port reads the profiler's
list of the kernels one call launched, with their device time.  On the
CPU (``--device cpu``, the tests) the same lines come from the host clock
and the profiler's CPU ops; they rehearse the tools, they time no card.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..device import resolve_device
from ..tiny_run import card_of

# A profiled pass of pool_cliff, phase_cliff and slope_trace runs at most
# this many simulations of a fresh tree: the counts a simulation need no
# more, and the profiler's own time grows with its events (~1,000 kernels
# a simulation at B=128).
PROFILE_SIMS = 4


def pools(text: str) -> list[int]:
    return [int(m) for m in text.split(",") if m]


def device_and_card(device: str):
    """The resolved device (``cuda`` raises without a card) and its
    ``nvidia-smi`` name and power limit (``cpu`` off the card)."""
    dev = resolve_device(device)
    return dev, card_of(dev)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ms_per_call(fn, dev: torch.device, calls: int = 1, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn()`` over ``calls`` calls after
    ``warmup`` calls: CUDA events on the card (the host's stalls between
    kernels included, as a caller sees them), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / calls


def kernel_profile(fn, dev: torch.device, shapes: bool = False) -> dict:
    """One call of ``fn()`` under ``torch.profiler``: the count of device
    kernels and their summed device milliseconds (on the CPU: the count of
    operators and their self CPU milliseconds, the rehearsal's stand-in),
    and with ``shapes`` a Counter of (operator, input shapes) over the
    call's operators and of device kernels by name."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=activities, record_shapes=shapes) as prof:
        fn()
        sync(dev)
    events = [e for e in prof.events() if not getattr(e, "is_user_annotation", False)]
    if dev.type == "cuda":
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        out = {"kernels": len(kernels), "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}
    else:
        ops = [e for e in events if e.device_type == DeviceType.CPU]
        out = {"cpu_ops": len(ops), "cpu_ms": sum(e.self_cpu_time_total for e in ops) / 1e3}
    if shapes:
        hist = collections.Counter()
        for e in events:
            if e.device_type == DeviceType.CUDA:
                hist[("kernel", e.name, "")] += 1
            elif e.name.startswith("aten::"):
                hist[("op", e.name, str(e.input_shapes))] += 1
        out["histogram"] = hist
    return out


def stub_evaluator(eng):
    """JAX's stub evaluator of these tools: zero logits and value, variance
    0.25, so that the tree's own ops take the time."""
    a = eng.num_actions

    def evaluate(envs):
        b, dev = envs.ply.shape[0], envs.ply.device
        return (torch.zeros((b, a), device=dev), torch.zeros((b,), device=dev),
                torch.full((b,), 0.25, device=dev))

    return evaluate


def openings(eng, batch: int, seed: int, dev: torch.device):
    """``batch`` fresh openings on ``dev`` from a seeded generator."""
    from ..search.openings import make_new_opening

    gen = torch.Generator(device=dev).manual_seed(seed)
    sym = torch.randint(0, 8, (batch,), generator=gen, device=dev)
    pair = torch.randint(0, 2, (batch,), generator=gen, device=dev)
    return make_new_opening(eng)(sym, pair)
