"""The port's TEI engine and analysis table against the JAX package's.

``TeiEngine`` runs the serve path (one plain simulate, then the wavefront
serve chunk) on the same weights as JAX's engine, bridged from JAX's
bundle; the protocol cases of ``tests/test_tei_stop.py``,
``tests/test_tools.py`` and ``tests/test_descend.py`` run again on the
port; ``print_root_table`` prints the same moves and visits as JAX's for
the same tree.  ``TAKZERO_TOPK=exact_ref`` makes JAX select children as
the port does.
"""

import io
import queue
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.drivers.analysis import print_root_table as jax_print_root_table
from takzero_tpu.drivers.tei import TeiEngine as JaxTeiEngine
from takzero_tpu.search import agents as jax_agents
from takzero_tpu.search import core as jax_core
from takzero_tpu.search import tree as jax_tree
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import ptn_to_action
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.drivers import analysis
from takzero_torch.drivers.tei import TeiEngine

from torch_parity import tree_to_torch

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _info(line: str) -> dict:
    """An ``info`` line's fields: time, nodes, nps, score and pv."""
    words = line.split()
    assert words[0] == "info", line
    pv = words[words.index("pv") + 1:]
    score = words[words.index("score") + 1: words.index("pv")]
    return {"time": int(words[2]), "nodes": int(words[4]), "nps": int(words[6]), "score": score, "pv": pv}


def test_tei_matches_jax_engine_on_the_same_weights():
    """``position startpos moves a1 c3`` + ``go nodes 256``: the same
    bestmove, PV, node counts and root flag/ply, the root value within
    1e-5 (the bf16 network's outputs agree with JAX's to float32 rounding).
    ``movetime`` is set far out so that the node budget, not JAX's compile
    time, ends both searches."""
    jout, tout = io.StringIO(), io.StringIO()
    je = JaxTeiEngine("tiny3", None, out=jout)
    te = TeiEngine("tiny3", None, out=tout, device="cpu")
    je.handle("isready")
    jout.truncate(0)
    jout.seek(0)
    te.bundle = from_jax_bundle(jax.tree.map(np.asarray, je.bundle), NET_PRESETS["tiny3"], device="cpu")
    for e in (je, te):
        for cmd in ("tei", "isready", "position startpos moves a1 c3", "go nodes 256 movetime 600000"):
            assert e.handle(cmd)
    jl, tl = jout.getvalue().splitlines(), tout.getvalue().splitlines()
    assert tl[0] == "id name takzero-torch" and jl[0] == "id name takzero-tpu"
    assert tl[1:] != [] and [x for x in tl[1:] if not x.startswith("info ")] == \
        [x for x in jl[1:] if not x.startswith("info ")]
    jinfo = [_info(x) for x in jl if x.startswith("info ")]
    tinfo = [_info(x) for x in tl if x.startswith("info ")]
    assert [(i["nodes"], i["pv"]) for i in tinfo] == [(i["nodes"], i["pv"]) for i in jinfo]
    assert tinfo[-1]["nodes"] == 256 and tinfo[-1]["pv"]
    assert tl[-1] == jl[-1] and tl[-1].startswith("bestmove ")
    assert tinfo[-1]["pv"][0] == tl[-1].split()[1]  # the PV starts with the move played
    for name in ("root_visit", "root_flag", "root_ply", "node_count"):
        np.testing.assert_array_equal(getattr(te.tree, name).numpy(), np.asarray(getattr(je.tree, name)), name)
    np.testing.assert_allclose(te.tree.root_value.numpy(), np.asarray(je.tree.root_value), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Protocol cases (tests/test_tei_stop.py, test_tools.py, test_descend.py).
# ---------------------------------------------------------------------------


def _engine():
    q = queue.Queue()
    out = io.StringIO()
    e = TeiEngine("tiny3", None, out=out, commands=q, device="cpu")
    e.handle("tei")
    e.handle("isready")
    e.handle("position startpos moves a3 c1")
    return e, q, out


def _stop_interrupts_go_infinite(e, q, out):
    q.put("stop\n")
    e.handle("go infinite")  # would never return without the stop
    lines = out.getvalue().splitlines()
    assert lines[-1].startswith("bestmove ")
    assert any(x.startswith("info ") for x in lines)
    assert not e.pending


def _quit_interrupts_search_and_requeues(e, q, out):
    q.put(None)  # EOF while searching = quit
    e.handle("go infinite")
    assert out.getvalue().splitlines()[-1].startswith("bestmove ")
    assert e.pending == ["quit"]


def _isready_answered_mid_search_and_commands_deferred(e, q, out):
    q.put("isready\n")
    q.put("position startpos moves a3 c1 b2\n")
    q.put("quit\n")  # behind a deferred command: must not abort this search
    e.handle("go nodes 128 movetime 60000")
    txt = out.getvalue().splitlines()
    assert "readyok" in txt
    assert txt[-1].startswith("bestmove ")
    assert int(e.tree.root_visit[0]) >= 128
    assert e.pending == ["position startpos moves a3 c1 b2", "quit"]


def _setoption_halfkomi_rebuilds_engine(e, q, out):
    e.handle("setoption name HalfKomi value 4")
    assert e.eng.half_komi == 4
    e.handle("isready")
    e.handle("position startpos moves a3 c1")
    e.handle("go nodes 128 movetime 60000")
    assert out.getvalue().splitlines()[-1].startswith("bestmove ")


def _stop_interrupts_even_behind_deferred_commands(e, q, out):
    q.put("position startpos moves a3 c1 b2\n")
    q.put("stop\n")
    e.handle("go infinite")
    assert out.getvalue().splitlines()[-1].startswith("bestmove ")
    assert e.pending == ["position startpos moves a3 c1 b2"]


def _quit_interrupts_infinite_behind_deferred_commands(e, q, out):
    q.put("isready\n")
    q.put("position startpos\n")
    q.put(None)  # EOF = quit; only stop/quit can end `infinite`
    e.handle("go infinite")
    assert out.getvalue().splitlines()[-1].startswith("bestmove ")
    assert e.pending[-1] == "quit"


def _setoption_model_keeps_position(e, q, out):
    e.handle("go nodes 128 movetime 60000")
    before = int(e.position.ply[0])
    e.handle("setoption name Model value /nonexistent-is-fine-unset")
    assert e.tree is None
    e.model_path = None  # do not load the fake path
    e.handle("go nodes 128 movetime 60000")
    assert int(e.position.ply[0]) == before
    assert out.getvalue().splitlines()[-1].startswith("bestmove ")


def _go_on_terminal_position_is_nullmove(e, q, out):
    e.handle("position startpos moves c3 a1 b1 b3 c1")  # white road a1-b1-c1
    e.handle("go movetime 1000")
    assert out.getvalue().splitlines()[-1] == "bestmove 0000"


def _malformed_commands_do_not_kill_engine(e, q, out):
    assert e.handle("position") is True
    assert e.handle("position foo") is True
    assert e.handle("go movetime abc") is True
    assert "info string error" in out.getvalue()
    e.handle("position startpos moves a3 c1")
    e.handle("go nodes 128 movetime 60000")
    assert out.getvalue().splitlines()[-1].startswith("bestmove ")


def _handshake_and_bestmove(e, q, out):
    assert "teiok" in out.getvalue() and "readyok" in out.getvalue()
    assert e.handle("teinewgame 3")
    assert e.handle("position startpos moves a1 c3")
    assert e.handle("go nodes 128 movetime 100000")
    text = out.getvalue()
    assert "info " in text and " pv " in text
    ptn_to_action(3, text.strip().splitlines()[-1].split()[-1])  # parses
    assert not e.handle("quit")


def _reuses_tree_across_positions(e, q, out):
    e.handle("go nodes 128 movetime 60000")
    visits_before = int(e.tree.root_visit[0])
    assert visits_before >= 128
    best = out.getvalue().splitlines()[-1].split()[-1]
    e.handle(f"position startpos moves a3 c1 {best}")
    assert e.tree is not None
    assert 0 < int(e.tree.root_visit[0]) < visits_before
    e.handle("position startpos moves b2")
    assert e.tree is None


PROTOCOL = {f.__name__[1:]: f for f in (
    _stop_interrupts_go_infinite, _quit_interrupts_search_and_requeues,
    _isready_answered_mid_search_and_commands_deferred, _setoption_halfkomi_rebuilds_engine,
    _stop_interrupts_even_behind_deferred_commands, _quit_interrupts_infinite_behind_deferred_commands,
    _setoption_model_keeps_position, _go_on_terminal_position_is_nullmove,
    _malformed_commands_do_not_kill_engine, _handshake_and_bestmove, _reuses_tree_across_positions,
)}


@pytest.mark.parametrize("case", list(PROTOCOL))
def test_tei_protocol(case):
    PROTOCOL[case](*_engine())


def test_tei_main_answers_from_stdin(monkeypatch, capsys):
    """``python -m takzero_torch.drivers.tei --net tiny3 --device cpu`` on
    piped commands: the handshake, a legal bestmove, and quit."""
    from takzero_torch.drivers import tei
    from takzero_torch.tak import engine as torch_engine

    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "tei\nisready\nposition startpos\ngo nodes 128\nquit\n"))
    tei.main(["--net", "tiny3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert "teiok" in lines and "readyok" in lines
    move = lines[-1].split()
    assert move[0] == "bestmove"
    eng = torch_engine(3)
    assert bool(eng.legal_mask(eng.initial(1))[0, ptn_to_action(3, move[1])])


# ---------------------------------------------------------------------------
# The analysis table.
# ---------------------------------------------------------------------------


def _table_columns(text: str):
    lines = text.splitlines()
    rows = [line.split() for line in lines[2:]]
    return lines[0].split()[1], [(r[0], r[1]) for r in rows]  # root visits, (move, visits)


def test_print_root_table_matches_jax():
    eng = jax_engine(3)
    simulate, simulate_batch = jax_core.make_kernels(eng, jax_agents.simple_evaluator(eng), max_depth=16)
    run = jax.jit(lambda t: simulate_batch(simulate(t, jnp.zeros(1)), jnp.zeros(1), 31))
    s = eng.initial()
    for mv in ("a3", "c1"):
        s = eng.step_jit(s, ptn_to_action(3, mv))
    jt = run(run(jax_tree.init_tree(eng, jax.tree.map(lambda x: x[None], s), 128, 48)))
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jax_print_root_table(3, jt, out=jbuf)
    analysis.print_root_table(3, tree_to_torch(jt), out=tbuf)
    assert _table_columns(tbuf.getvalue()) == _table_columns(jbuf.getvalue())
    assert tbuf.getvalue().splitlines()[:2] == jbuf.getvalue().splitlines()[:2]
    assert len(tbuf.getvalue().splitlines()) == 2 + int((np.asarray(jt.child_action[0, 0]) >= 0).sum())


def test_analysis_main_runs_a_chunk(monkeypatch, capsys):
    """The REPL on the CPU: a non-move line runs one chunk (128 visits at
    the root) and prints the table; a legal move is played."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("go\na1\nzz9\nquit\n"))
    analysis.main(["--net", "tiny3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "x3/x3/x3 1 1"
    assert out[out.index(out[0]) + 1].startswith("root: visits=128 ")
    assert sum(x.startswith("root: visits=128 ") for x in out) == 2  # "go" and "zz9"
    assert [x for x in out if "/" in x][1].endswith(" 2 1")  # a1 played: black to move
