"""The port's spans (``takzero_torch/utils/profile.py``) on the CPU.

A span is a ``torch.profiler`` range while a profiler records and one
shared no-op otherwise.  The search's four phases, the actor's move, TEI's
two commands and the serve chunk's phases are spans under the names the
benchmark's readers match, nested as the calls are, and every blocking read
of the device is a ``sync`` span holding that read alone.
"""

import contextlib
import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from takzero_torch.drivers.tei import TeiEngine, make_run_chunk
from takzero_torch.search.agents import dummy_evaluator
from takzero_torch.search.core import make_kernels
from takzero_torch.search.tree import init_tree
from takzero_torch.selfplay import SelfplayConfig, SelfplayEngine, make_draws
from takzero_torch.tak.engine import engine
from takzero_torch.utils.profile import host_item, span

torch.set_num_threads(2)

PHASES = ("search.forward", "search.evaluate", "search.apply_eval", "search.backward")


def _events(fn) -> list:
    """``(name, start_us, end_us)`` of every host event ``fn`` records, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.name, e.time_range.start, e.time_range.end) for e in prof.events())


def _named(events, *names) -> list:
    return sorted((e for e in events if e[0] in names), key=lambda e: e[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _search(n=3, batch=3, warm=3):
    """A tiny batch of trees after ``warm`` simulations with the dummy
    evaluator, and its ``(simulate, simulate_batch)``."""
    eng = engine(n)
    tree = init_tree(eng, eng.initial(batch), 64, 16)
    simulate, simulate_batch = make_kernels(eng, dummy_evaluator(eng), max_depth=8, topk="exact_ref")
    for _ in range(warm):
        simulate(tree, 0.0)
    return tree, simulate, simulate_batch


def test_span_is_a_shared_no_op_with_the_profiler_off():
    off = span("a")
    assert isinstance(off, contextlib.nullcontext) and span("b") is off
    with span("early"):  # entered before the profiler starts: never recorded
        events = _events(lambda: torch.ones(2).add_(1))
    assert not _named(events, "early", "a", "b")


def test_span_records_its_name_with_the_profiler_on():
    def body():
        with span("outer.phase"):
            x = torch.ones(3)
            with span("inner.phase"):
                x.add_(1)

    events = _events(body)
    (outer,), (inner,) = _named(events, "outer.phase"), _named(events, "inner.phase")
    assert _inside(inner, outer)
    assert any(e[0] == "aten::add_" and _inside(e, inner) for e in events)


def test_host_item_reads_inside_a_sync_span():
    x = torch.tensor([7], dtype=torch.int32)
    got = []
    events = _events(lambda: got.append(host_item(x)))
    assert got == [7] and isinstance(got[0], int)
    (sync,) = _named(events, "sync")
    (read,) = _named(events, "aten::_local_scalar_dense")
    assert _inside(read, sync)


def test_simulate_records_each_phase_once_in_order():
    tree, simulate, _ = _search()
    events = _events(lambda: simulate(tree, 0.0))
    spans = _named(events, *PHASES)
    assert [e[0] for e in spans] == list(PHASES)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # no overlap


def test_every_read_in_simulate_is_one_sync_span():
    tree, simulate, _ = _search()
    events = _events(lambda: simulate(tree, 0.0))
    syncs = _named(events, "sync")
    reads = _named(events, "aten::_local_scalar_dense")
    assert len(syncs) >= 2  # at least one level of the descent, and the backup
    assert all(sum(_inside(r, s) for s in syncs) == 1 for r in reads)
    assert all(sum(_inside(r, s) for r in reads) == 1 for s in syncs)
    # The levels' reads in the descent, then the backup's one read in the
    # backup (the CPU's loops; a CUDA tree's kernels read nothing).
    forward, backward = _named(events, "search.forward")[0], _named(events, "search.backward")[0]
    assert all(_inside(s, forward) for s in syncs[:-1]) and _inside(syncs[-1], backward)


def test_simulate_batch_records_k_descents_then_one_evaluation():
    tree, _, simulate_batch = _search()
    events = _events(lambda: simulate_batch(tree, 0.0, 2))
    names = [e[0] for e in _named(events, *PHASES)]
    assert names == ["search.forward", "search.backward"] * 2 + ["search.evaluate"] + \
        ["search.apply_eval", "search.backward"] * 2


@pytest.fixture(scope="module")
def actor():
    eng = engine(3)
    cfg = SelfplayConfig(batch=2, search_budget=4, sampled_actions=2, max_children=16, max_depth=8)
    evaluate = dummy_evaluator(eng)
    sp = SelfplayEngine(eng, cfg, lambda agent, envs: evaluate(envs), device="cpu", topk="exact_ref")
    gen = torch.Generator().manual_seed(3)
    sp.reset(make_draws(gen, cfg.batch, cfg.max_children))
    sp.play_move(None, make_draws(gen, cfg.batch, cfg.max_children))
    return sp, gen


def test_play_move_records_move_readback_then_host_half(actor):
    sp, gen = actor
    draws = make_draws(gen, sp.cfg.batch, sp.cfg.max_children)
    events = _events(lambda: sp.play_move(None, draws))
    (move,), (half,) = _named(events, "selfplay.move"), _named(events, "selfplay.host_half")
    readback = [s for s in _named(events, "sync") if not _inside(s, move)]
    assert len(readback) == 1 and move[2] <= readback[0][1] and readback[0][2] <= half[1]
    # The search runs inside the device half, every simulation of it.
    sims = sp.cfg.search_budget + 1
    assert all(_inside(e, move) for e in _named(events, *PHASES))
    assert len(_named(events, "search.evaluate")) == sims


def test_tei_records_position_then_go_with_the_chunk_inside():
    eng = TeiEngine("tiny3", None, out=io.StringIO(), device="cpu")
    eng.handle("isready")
    # A chunk of 8 simulations (a go counts 128 nodes a chunk all the same).
    eng._run = make_run_chunk(eng.cfg, eng.eng, eng.bundle, eng.device, sim_chunk=8)

    def commands():
        assert eng.handle("position startpos moves a1 c3")
        assert eng.handle("go nodes 128")

    events = _events(commands)
    (position,), (go,) = _named(events, "tei.position"), _named(events, "tei.go")
    assert position[2] <= go[1]
    chunk = _named(events, *(f"serve_chunk.{p}" for p in "ABCD"))
    assert [e[0] for e in chunk] == [f"serve_chunk.{p}" for p in "ABCD"]
    assert all(_inside(e, go) for e in chunk + _named(events, *PHASES))
    # Every read of the go (terminal kind, side to move, the plain
    # simulation's levels, the chunk's deepest level, the info buffer, the
    # best slot) lies inside it.
    syncs = _named(events, "sync")
    assert sum(_inside(s, go) for s in syncs) >= 6
    assert all(_inside(s, position) or _inside(s, go) for s in syncs)
    reads = _named(events, "aten::_local_scalar_dense")
    assert all(sum(_inside(r, s) for s in syncs) == 1 for r in reads)
