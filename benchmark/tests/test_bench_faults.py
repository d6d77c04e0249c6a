"""Whole runs of each cell at a small size on the CPU (the look for a card
skipped), with the cell's real limits: a sound run is correct, a run with
the measured path broken underneath is not (an answer altered where it is
produced, a state left unchanged, half the simulations, the search's
candidates or backup wrong), and the control (the reference in float8, its
backup in bfloat16, put in the program's place) fails a limit."""

import argparse
import contextlib
import dataclasses

import pytest
import torch

from benchmark.harness import result, spec
from benchmark.kinds import selfplay, serve


def small(cell: str):
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    cfg.update(filters=16, blocks=2)
    if cfg["novelty"] == "simhash":
        cfg["hash_bits"] = 20
    if traffic["kind"] == "selfplay":
        cfg.update(batch=8, sampled_actions=4, search_budget=8)
        traffic.update(check_nodes=64)
    else:
        traffic.update(check_nodes=64)
    return bench, w, cfg, traffic


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def small_engine_preset():
    from takzero_torch import config

    old = config.NET_PRESETS["net6_simhash"]
    with patched(config, "NET_PRESETS", {**config.NET_PRESETS, "net6_simhash": dataclasses.replace(
            old, filters=16, blocks=2, hash_bits=20)}):
        yield


def run(cell: str, seconds: float = 0.5) -> dict:
    bench, w, cfg, traffic = small(cell)
    kind = {"selfplay": selfplay, "serve": serve}[traffic["kind"]]
    args = argparse.Namespace(seed=2**31 + 1234, seconds=seconds, trace=0)
    torch.set_num_threads(2)
    ctx = small_engine_preset() if traffic["kind"] == "serve" else contextlib.nullcontext()
    with ctx:
        return kind.run(bench, w, cfg, traffic, args, device="cpu")


def failed(out: dict) -> list:  # the compared numbers over their limits
    return [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]


# ---------------------------------------------------------------------------
# Selfplay: an answer altered where it is produced (the evaluator's logits,
# kernel A's choice), a move that leaves the game's state unchanged, and a
# search that runs half its simulations, ignores the Gumbel draw or backs up
# undiscounted returns.
# ---------------------------------------------------------------------------


def _logits_off(real):
    def apply_folded(cfg, fw, planes, with_core=False):
        out = list(real(cfg, fw, planes, with_core))
        out[0] = out[0].clone()
        out[0][0] += 0.5 * out[0][0].abs().max()
        return tuple(out)
    return apply_folded


def _drop_a_child(real):
    def topk(x, k):
        x = x.clone()
        x[:, 0] = -3.0e38  # the first action never becomes a child
        return real(x, k)
    return topk


def _state_unchanged(real):
    def move(self, envs, tree, agent, draws):
        _, tree_out, packed, root = real(self, envs, tree, agent, draws)
        return envs, tree_out, packed, root
    return move


def _half_the_simulations(real):
    def sh_schedule(k, budget):
        return tuple(x[: len(x) // 2] for x in real(k, budget))
    return sh_schedule


def _no_gumbel_noise(real):
    def make_gumbel_search(*a, **k):
        search = real(*a, **k)
        return lambda tree, gumbel, betas: search(tree, torch.zeros_like(gumbel), betas)
    return make_gumbel_search


@pytest.mark.parametrize("cell", ["selfplay.net6_simhash", "selfplay.net5"])
def test_selfplay_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["logits", "kernel_a", "state", "half_sims", "candidates", "backup"])
def test_selfplay_fault_is_caught(fault):
    from takzero_torch import selfplay as program
    from takzero_torch.models import agent
    from takzero_torch.search import core, gumbel
    from takzero_torch.search import eval as ev
    from takzero_torch.selfplay import SelfplayEngine

    target = {"logits": (agent, "apply_folded", _logits_off), "kernel_a": (core, "_kernel_a", _drop_a_child),
              "state": (SelfplayEngine, "move", _state_unchanged),
              "half_sims": (gumbel, "sh_schedule", _half_the_simulations),
              "candidates": (program, "make_gumbel_search", _no_gumbel_noise),
              "backup": (ev, "DISCOUNT", lambda real: 1.0)}[fault]  # returns backed up undiscounted
    with patched(target[0], target[1], target[2](getattr(target[0], target[1]))):
        out = run("selfplay.net6_simhash")
    assert not out["correct"] and failed(out)


@pytest.mark.parametrize("cell", ["selfplay.net6_simhash", "selfplay.net5"])
def test_selfplay_control_fails(cell):
    bench, w, cfg, traffic = small(cell)
    torch.set_num_threads(2)
    s = selfplay.session(w, cfg, traffic, 2**31 + 55, 0.5, False, "cpu")
    values = selfplay.control_readings(cfg, s.obs, s.weights, torch.device("cpu"))
    correct, _ = result.judge(values, spec.limits(cell))
    assert not correct


# ---------------------------------------------------------------------------
# Serve: a bestmove altered where the engine picks it, and a go that runs
# half its nodes.
# ---------------------------------------------------------------------------


def test_serve_sound_run_is_correct():
    out = run("serve.net6_simhash", seconds=1.0)
    assert out["correct"], out["checks"]


def test_serve_altered_bestmove_is_caught():
    from takzero_torch.drivers import tei

    def least_visited(tree):
        visits = torch.where(tree.child_action[:, 0, :] >= 0, tree.child_visit[:, 0, :], 1 << 30)
        return visits.argmin(-1)

    with patched(tei, "select_best_slot", least_visited):
        out = run("serve.net6_simhash", seconds=1.0)
    assert not out["correct"] and "bestmove_errors" in failed(out)


def test_serve_half_the_nodes_is_caught():
    from takzero_torch.drivers import tei

    real = tei.make_run_chunk

    def make_run_chunk(*a, **k):  # each go nodes N runs N / 2 simulations
        return real(*a, **{**k, "sim_chunk": tei.SIM_CHUNK // 2})

    with patched(tei, "make_run_chunk", make_run_chunk):
        out = run("serve.net6_simhash", seconds=1.0)
    assert not out["correct"] and "sims_errors" in failed(out)
