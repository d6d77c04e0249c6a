"""The port's C++ rules oracle (``takzero_torch/tak/oracle.py`` over
``takzero_torch/cpp/``) against JAX's, and the port's engine fuzzed
against it.

The port keeps its own byte-identical copy of the C++ sources and builds it
into ``build/``; its binding must give JAX's binding's answers on every
entry point (masks, states through ``tests/torch_parity.py``, results,
playouts, the exact solver's labels), and the port's engine must give the
oracle's legal mask, stepped state and result at every ply of random games
at n = 3 to 6, as ``tests/test_oracle_fuzz.py`` holds JAX's engine.
"""

import jax
import numpy as np
import pytest
import torch

from takzero_tpu.tak.oracle import Oracle as JaxOracle
from takzero_tpu.tak.state import initial_state as jax_initial
from takzero_torch.ops import _cpp_build
from takzero_torch.tak import engine
from takzero_torch.tak.oracle import Oracle, initial_state, oracle_opening, pack_state, unpack_state
from takzero_torch.tak.state import TakState

from torch_parity import assert_state_equal, state_to_jax

torch.set_num_threads(2)

JAX_CPP = _cpp_build.CPP.parents[1] / "takzero_tpu" / "cpp"
SOURCES = ("tak_core.hpp", "tak_oracle.cpp", "tak_solver.cpp", "tak_io.cpp", "tak_mcts_bench.cpp")
KOMI = {3: 0, 4: 4, 5: 4, 6: 4}


def test_cpp_sources_are_jax_copies():
    assert sorted(p.name for p in _cpp_build.CPP.iterdir()) == sorted(SOURCES)
    for name in SOURCES:
        assert (_cpp_build.CPP / name).read_bytes() == (JAX_CPP / name).read_bytes(), name


def _snapshot(d):
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in d.iterdir()}


def test_build_lands_in_build_dir_and_rebuilds_on_header_edit(tmp_path, monkeypatch):
    """Both targets build into the build directory (named by a hash), never
    under ``takzero_tpu/cpp/``; an edited header gives a new name."""
    before = _snapshot(JAX_CPP)
    monkeypatch.setattr(_cpp_build, "BUILD_DIR", tmp_path / "build")
    lib = _cpp_build.build("tak_oracle")
    bench = _cpp_build.build("tak_mcts_bench")
    assert lib.parent == bench.parent == tmp_path / "build"
    assert lib.name.startswith("libtak_oracle-") and lib.suffix == ".so" and bench.name.startswith("tak_mcts_bench-")
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted([lib.name, bench.name])
    assert _cpp_build.build("tak_oracle") == lib  # built once
    edited = tmp_path / "cpp"
    edited.mkdir()
    for name in SOURCES:
        (edited / name).write_bytes((_cpp_build.CPP / name).read_bytes())
    (edited / "tak_core.hpp").write_text((edited / "tak_core.hpp").read_text() + "\n// edited\n")
    monkeypatch.setattr(_cpp_build, "CPP", edited)
    assert _cpp_build.output_path("tak_oracle") != lib
    assert _cpp_build.output_path("tak_mcts_bench") != bench
    assert _snapshot(JAX_CPP) == before


def test_compiler_failure_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_cpp_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building tak_mcts_bench failed"):
        _cpp_build.build("tak_mcts_bench")
    assert not any(tmp_path.iterdir())


def _jax_start(n):
    return jax.tree.map(np.asarray, jax_initial(n))


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_oracle_matches_jax_on_playouts(n):
    """legal_mask, step, result at every ply of random playouts, and the
    playouts' actions and results, from the same seeds."""
    orc, jorc = Oracle(n, KOMI[n]), JaxOracle(n, KOMI[n])
    start = initial_state(n)
    assert_state_equal(start, _jax_start(n), "start")
    np.testing.assert_array_equal(unpack_state(n, pack_state(n, start)).owner, start.owner)
    for seed in (1, 2):
        end, actions, res = orc.random_playout(start, seed=seed + n)
        jend, jactions, jres = jorc.random_playout(_jax_start(n), seed=seed + n)
        assert (actions, res) == (jactions, jres)
        assert_state_equal(end, jend, f"n={n} playout end")
        cur, jcur = start, _jax_start(n)
        for ply, a in enumerate(actions):
            np.testing.assert_array_equal(orc.legal_mask(cur), jorc.legal_mask(jcur), err_msg=f"ply {ply}")
            assert orc.result(cur) == jorc.result(jcur) == -1
            cur, jcur = orc.step(cur, a), jorc.step(jcur, a)
            assert_state_equal(cur, jcur, f"n={n} seed={seed} ply {ply}")
        assert orc.result(cur) == jorc.result(jcur) == res


def test_oracle_opening_draws_as_jax():
    from takzero_tpu.tak import engine as jax_engine
    from takzero_tpu.train.data import _host_opening

    for n in (3, 6):
        rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
        orc, jorc = Oracle(n, KOMI[n]), JaxOracle(n, KOMI[n])
        for _ in range(6):
            assert_state_equal(oracle_opening(orc, rng), _host_opening(jax_engine(n, KOMI[n]), jorc, jrng))
        assert rng.integers(1 << 30) == jrng.integers(1 << 30)


def _late_positions(orc, n, seeds, last=5):
    out = []
    for seed in seeds:
        _, actions, res = orc.random_playout(initial_state(n), seed=seed)
        cur, states = initial_state(n), []
        for a in actions:
            states.append(cur)
            cur = orc.step(cur, a)
        out += states[-last:]
    return out


@pytest.mark.parametrize("n,budget", [(3, 200_000), (4, 20_000)])
def test_solver_labels_match_jax(n, budget):
    """tinue_depth, loses_within, avoidance_status and the laddered status
    equal JAX's on late positions of random games (small node budgets: the
    -1/-3 'unknown' answers must agree too)."""
    orc, jorc = Oracle(n, KOMI[n]), JaxOracle(n, KOMI[n])
    checked = 0
    for st in _late_positions(orc, n, seeds=range(30, 36)):
        js = state_to_jax(st)
        assert orc.tinue_depth(st, 5, budget) == jorc.tinue_depth(js, 5, budget)
        assert orc.loses_within(st, 2, budget) == jorc.loses_within(js, 2, budget)
        np.testing.assert_array_equal(orc.avoidance_status(st, 3, budget), jorc.avoidance_status(js, 3, budget))
        np.testing.assert_array_equal(orc.avoidance_status_laddered(st, 3, budget // 100, budget),
                                      jorc.avoidance_status_laddered(js, 3, budget // 100, budget))
        checked += 1
    assert checked >= 20


def _lane(state: TakState) -> TakState:
    return state.map(lambda x: x[0])


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_engine_fuzz_vs_oracle(n):
    """The port's engine against the port's oracle at every ply of random
    games: legal mask, stepped state (every field, ``reversible`` included)
    and result."""
    eng = engine(n, half_komi=KOMI[n])
    orc = Oracle(n, half_komi=KOMI[n])
    rng = np.random.default_rng(1234 + n)
    games = 2 if n >= 5 else 3
    for g in range(games):
        state = eng.initial(1)
        ply = 0
        while True:
            mask = eng.legal_mask(state)[0].numpy()
            np.testing.assert_array_equal(mask, orc.legal_mask(_lane(state)), err_msg=f"n={n} g={g} ply={ply}")
            res = int(eng.game_result(state)[0])
            assert res == orc.result(_lane(state)), f"n={n} g={g} ply={ply}"
            if res != -1 or ply > 250:
                break
            action = int(rng.choice(np.nonzero(mask)[0]))
            nxt = eng.step(state, torch.tensor([action]))
            want = orc.step(_lane(state), action)
            for name, got, exp in zip(TakState._fields, _lane(nxt), want):
                assert torch.equal(got.to(exp.dtype), exp), f"n={n} g={g} ply={ply} action={action}: {name}"
            state = nxt
            ply += 1
