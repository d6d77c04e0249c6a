"""Smoke test of the PyTorch/CUDA port (``takzero_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
It imports nothing of JAX or of ``takzero_tpu``.  Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. the build of every kernel from ``takzero_torch/csrc`` (seconds);
3. kernel A (exact unsorted top-k) against ``topk_plain`` at the main
   path's f32[128, 9036], k=256, on masked logits of random 6x6 positions,
   all-tie rows, rows with fewer than 256 legal entries and +-inf rows:
   values and indices must match exactly;
4. kernel B (SimHash pack) against ``simhash_plain`` at 26 and 32 bits:
   every bit whose float64 dot satisfies |dot| > 1e-4 must match;
5. a small reference check: the 3x3 move program (dummy evaluator) and a
   small float32 network evaluation on the card against the same on the
   CPU, the path the CPU tests hold against the JAX package;
6. the main path: ``takzero_torch.bench`` at the flagship configuration
   (6x6, 16x256 bf16 net, SimHash 2^26, batch 128, k=64, budget 768,
   C=256, tree reuse), one warm-up move and two timed moves.  Both kernels'
   launch counters are set to 0 before and must read (budget+1) per move
   after; chosen actions must be legal and tree values finite;
7. a ``kernels`` JSON line: each kernel with what it replaces, its launches
   on the main path, its error against the plain version, its time, the
   plain version's time, its bound and the library call's time.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises,
so the script exits non-zero and prints no such line; without a CUDA card
it exits with 1 at once.  Kernel times are CUDA-event means over 200
launches after 20 warm-up launches.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory bandwidth
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
NEG = -3.0e38


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def random_positions(eng, batch: int, plies: int, gen, dev):
    """Random 6x6 playout positions on the card, of random length."""
    import torch

    from takzero_torch.tak.state import where_state

    envs = eng.initial(batch, dev)
    stop = torch.randint(0, plies + 1, (batch,), generator=gen, device=dev)
    for p in range(plies):
        legal = eng.legal_mask(envs)
        any_legal = legal.any(-1, keepdim=True)
        live = (p < stop) & (eng.terminal_kind(envs) == 0) & any_legal[:, 0]
        act = torch.multinomial((legal | ~any_legal).float(), 1, generator=gen)[:, 0]
        envs = where_state(live, eng.step(envs, act), envs)
    return envs


def check_topk(eng, envs, gen, dev) -> dict:
    import torch

    from takzero_torch.ops import topk

    legal = eng.legal_mask(envs)
    b, a = legal.shape
    logits = torch.randn(b, a, generator=gen, device=dev)
    x = torch.where(legal, logits, NEG)
    x[96:112] = torch.where(legal[96:112], 1.0, NEG)  # the dummy evaluator: all ties
    x[112:116] = -torch.inf  # fewer than k finite entries
    x[112:116, 500:520] = 2.0
    x[116:120, 7] = torch.inf
    x[120:124] = 1.0  # all equal, nothing masked
    x[124:128] = logits[124:128]  # more than k candidates, nothing masked
    x = x.contiguous()
    k = 256
    vals, idx = topk.exact_top_k_unsorted(x, k)
    pv, pi = topk.topk_plain(x, k)
    torch.cuda.synchronize()
    if not torch.equal(idx, pi):
        bad = (idx != pi).any(-1).nonzero()[:, 0].tolist()
        raise AssertionError(f"top-k kernel: indices differ from the plain version in rows {bad}")
    if not torch.equal(vals, pv):
        raise AssertionError("top-k kernel: values differ from the plain version")
    err = torch.where(vals == pv, 0.0, (vals - pv).abs()).max().item()
    few = int((legal.sum(-1) < k).sum())
    out = dict(
        shape=[b, a], k=k, rows_fewer_than_k_legal=few, max_abs_err=err,
        kernel_ms=cuda_ms(lambda: topk.exact_top_k_unsorted(x, k)),
        plain_ms=cuda_ms(lambda: topk.topk_plain(x, k)),
        library_ms=cuda_ms(lambda: torch.topk(x, k, sorted=False)),
    )
    out["bound_ms"], out["bound_by"] = bound_ms(b * a * 4 + b * k * 8, b * a)
    log({"phase": "kernel A exact_top_k_unsorted", **out})
    return out


def check_simhash(eng, envs, dev) -> dict:
    import torch

    from takzero_torch.models.network import NetConfig, simhash_matrix
    from takzero_torch.ops import simhash
    from takzero_torch.ops.repr import input_channels, state_to_planes

    planes = state_to_planes(eng, envs)
    planes[:, input_channels(eng.n) - 2] = 0.0
    x = planes.reshape(planes.shape[0], -1).contiguous()
    result = None
    for bits in (26, 32):
        m = simhash_matrix(NetConfig(n=6, hash_bits=bits), seed=0).to(dev)
        got = simhash.simhash_pack(x, m)
        want = simhash.simhash_plain(x, m)
        dots = x.double() @ m.double()
        sure = ((dots.abs() > 1e-4).long() << torch.arange(bits, device=dev)).sum(-1)
        diff = ((got & sure) != (want & sure)).sum().item()
        if diff:
            raise AssertionError(f"SimHash kernel ({bits} bits): {diff} words differ from plain")
        b, inp = x.shape
        out = dict(
            shape=[b, inp, bits], max_abs_err=float(((got & sure) - (want & sure)).abs().max()),
            near_zero_bits=int((dots.abs() <= 1e-4).sum()),
            kernel_ms=cuda_ms(lambda: simhash.simhash_pack(x, m)),
            plain_ms=cuda_ms(lambda: simhash.simhash_plain(x, m)),
            library_ms=None,
        )
        out["bound_ms"], out["bound_by"] = bound_ms(b * inp * 4 + inp * bits * 4 + b * 4, 2 * b * inp * bits)
        log({"phase": f"kernel B simhash_pack, {bits} bits", **out})
        if bits == 26:  # the main path's width
            result = out
    return result


def check_small_reference(dev) -> None:
    """The 3x3 move program and a small network, on the card vs the CPU."""
    import dataclasses

    import torch

    from takzero_torch.config import NET_PRESETS, selfplay_preset
    from takzero_torch.models.agent import make_net_evaluate, new_agent
    from takzero_torch.search.agents import dummy_evaluator
    from takzero_torch.selfplay import SelfplayEngine, make_draws
    from takzero_torch.tak.engine import engine

    eng = engine(3)
    sp_cfg = selfplay_preset("tiny3", batch=8, search_budget=16, sampled_actions=4, max_children=32)
    factory = lambda agent, envs: dummy_evaluator(eng)(envs)  # noqa: E731
    runs = {}
    for where in ("cpu", "cuda"):
        sp = SelfplayEngine(eng, sp_cfg, factory, device=where)
        gen = torch.Generator().manual_seed(3)
        sp.reset({k: v.to(where) for k, v in make_draws(gen, 8, 32).items()})
        envs, tree, out = sp.envs, sp.tree, []
        for _ in range(4):
            draws = {k: v.to(where) for k, v in make_draws(gen, 8, 32).items()}
            envs, tree, packed, _ = sp.move(envs, tree, None, draws)
            out.append(packed.cpu())
        runs[where] = torch.stack(out)
    c = sp_cfg.max_children
    ints = torch.cat([runs["cpu"][..., :4], runs["cpu"][..., 5 + c:]], -1)
    ints_gpu = torch.cat([runs["cuda"][..., :4], runs["cuda"][..., 5 + c:]], -1)
    if not torch.equal(ints, ints_gpu):
        raise AssertionError("3x3 move program: integer columns differ between card and CPU")
    floats = runs["cpu"][..., 4:5 + c].view(torch.float32)
    floats_gpu = runs["cuda"][..., 4:5 + c].view(torch.float32)
    torch.testing.assert_close(floats_gpu, floats, rtol=1e-5, atol=1e-5)

    cfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    agent_cpu = new_agent(cfg, seed=2, device="cpu")
    agent_gpu = new_agent(cfg, seed=2, device=dev)
    envs = random_positions(eng, 64, 8, torch.Generator().manual_seed(4), "cpu")
    want = make_net_evaluate(cfg, eng, device="cpu")(agent_cpu, envs)
    got = make_net_evaluate(cfg, eng, device=dev)(agent_gpu, envs.map(lambda t: t.to(dev)))
    for g, w, what in zip(got, want, ("policy", "value", "variance")):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4, msg=lambda m: f"{what}: {m}")
    log({"phase": "small reference", "move_program_3x3": "card == cpu", "network_f32": "within 1e-4"})


def run_main_path(dev) -> tuple[dict, object]:
    import torch

    from takzero_torch import bench
    from takzero_torch.ops import simhash, topk
    from takzero_torch.tak.engine import engine

    cfg = bench.BenchConfig()  # the flagship configuration, two timed moves
    topk.exact_top_k_unsorted.launches = 0
    simhash.simhash_pack.launches = 0
    res = bench.run(cfg, device=dev)
    launches = {
        "exact_top_k_unsorted": topk.exact_top_k_unsorted.launches,
        "simhash_pack": simhash.simhash_pack.launches,
    }
    expect = (cfg.budget + 1) * (cfg.moves + 1)  # the warm-up move included
    for name, count in launches.items():
        if count != expect:
            raise AssertionError(f"{name}: {count} launches on the main path, expected {expect}")

    eng = engine(6, half_komi=4)
    action = res.packed[:, 0].to(dev, torch.int64)
    legal = eng.legal_mask(res.envs_before).gather(1, action[:, None])[:, 0]
    if not bool(legal.all()):
        raise AssertionError(f"illegal actions chosen in lanes {(~legal).nonzero()[:, 0].tolist()}")
    tree = res.tree
    live = tree.node_live[:, :, None].expand_as(tree.child_value)
    for name in ("child_value", "child_std", "child_prob"):
        if not bool(torch.isfinite(getattr(tree, name)[live]).all()):
            raise AssertionError(f"non-finite {name} in the tree")
    for name in ("root_value", "root_std"):
        if not bool(torch.isfinite(getattr(tree, name)).all()):
            raise AssertionError(f"non-finite {name}")
    c = res.max_children
    pol = res.packed[:, 5:5 + c].view(torch.float32)
    if not torch.allclose(pol.sum(-1), torch.ones(pol.shape[0]), atol=1e-4):
        raise AssertionError("improved policy rows do not sum to 1")
    line = res.json_line()
    log({
        "phase": "main path", **line,
        "seconds_per_move": res.per_move_s, "warmup_move_s": res.warmup_s,
        "launches": launches, "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    })
    return launches, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "takzero_torch").is_dir():
        print("chip_smoke: run from the repository root (takzero_torch/ not found)", file=sys.stderr)
        return 1
    from takzero_torch.ops import _build
    from takzero_torch.tak.engine import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log(card_line())
    log({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_kernel = _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": per_kernel})

    gen = torch.Generator(device=dev).manual_seed(0)
    eng = engine(6, half_komi=4)
    envs = random_positions(eng, 128, 40, gen, dev)
    topk_out = check_topk(eng, envs, gen, dev)
    simhash_out = check_simhash(eng, envs, dev)
    check_small_reference(dev)
    launches, _ = run_main_path(dev)

    kernels = []
    for name, out, source, replaces in (
        ("exact_top_k_unsorted", topk_out, "takzero_torch/csrc/topk.cu", "takzero_tpu/ops/topk.py:57"),
        ("simhash_pack", simhash_out, "takzero_torch/csrc/simhash.cu",
         "takzero_tpu/ops/pallas_kernels.py:25"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "checked": True, "launches": launches[name], "max_abs_err": out["max_abs_err"],
            "ms": out["kernel_ms"], "plain_ms": out["plain_ms"], "bound_ms": out["bound_ms"],
            "bound_by": out["bound_by"], "library_ms": out["library_ms"],
        })
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    log(card_line())
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
