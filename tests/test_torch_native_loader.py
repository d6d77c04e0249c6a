"""The port's native loader (``takzero_torch/data/native_loader.py``, its
ctypes binding of the port's copy of ``cpp/tak_io.cpp``) against the JAX
package's on the same text: the cases of ``tests/test_native_loader.py``
that concern ``parse_tps``, ``parse_ptn``, ``parse_targets``,
``parse_replay_positions`` and ``make_batch_native``.

Integers and states exactly, floats byte for byte; malformed target lines
dropped and a replay with a bad move token dropped whole, as in JAX.  The
games come from JAX's oracle playouts (``tests/test_native_loader.py``'s
``_random_games``).
"""

import numpy as np
import pytest
import torch

from takzero_tpu.data import native_loader as jax_nl
from takzero_tpu.data.target import Replay as JaxReplay
from takzero_tpu.data.target import Target as JaxTarget
from takzero_tpu.data.target import _fmt as jax_fmt
from takzero_tpu.tak import action_to_ptn, engine, state_to_tps
from takzero_tpu.tak.oracle import Oracle
from takzero_tpu.train.data import _host_opening
from takzero_torch.data import native_loader as nl
from takzero_torch.data.target import Replay, Target, _fmt
from takzero_torch.tak.engine import engine as torch_engine
from takzero_torch.tak.moves import ptn_to_action
from takzero_torch.tak.tps import tps_to_state

from torch_parity import assert_state_equal


def _random_games(n, half_komi, games, seed, max_plies=80):
    eng = engine(n, half_komi=half_komi)
    orc = Oracle(n, half_komi, eng.reversible_limit)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(games):
        start = _host_opening(eng, orc, rng)
        _, actions, res = orc.random_playout(start, seed=int(rng.integers(1, 2**31)), max_plies=max_plies)
        out.append((start, [int(a) for a in actions], res))
    return eng, orc, rng, out


def _targets(n, half_komi, games, seed, plies, uniform=False):
    """Target lines along JAX's random games: random values and policies
    over the legal moves (uniform with ``uniform``)."""
    eng, orc, rng, played = _random_games(n, half_komi, games, seed, max_plies=3 * plies)
    lines = []
    for start, actions, _ in played:
        state = start
        for a in actions[:plies]:
            legal = np.nonzero(orc.legal_mask(state))[0]
            probs = np.full(len(legal), 1.0 / len(legal), np.float32)
            if not uniform:
                probs = rng.random(len(legal)).astype(np.float32)
                probs /= probs.sum()
            lines.append(JaxTarget(tps=state_to_tps(n, state), value=float(rng.uniform(-1, 1)),
                                   ube=float(rng.uniform(0, 4)), policy=[(int(x), float(p)) for x, p in
                                                                         zip(legal, probs)], n=n).to_line())
            state = orc.step(state, a)
    return eng, lines


def _expect_targets_equal(got, want):
    assert len(got) == len(want)
    assert_state_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.asarray(w).dtype
        assert g.tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("n,half_komi", [(3, 0), (4, 4), (6, 4)])
def test_parse_tps_and_ptn_match_jax(n, half_komi):
    _, orc, _, games = _random_games(n, half_komi, 4, seed=n)
    for start, actions, _ in games:
        state = start
        for a in actions[:40]:
            tps = state_to_tps(n, state)
            got = nl.parse_tps(n, tps)
            assert_state_equal(got, jax_nl.parse_tps(n, tps), tps)
            for name, x in tps_to_state(n, tps)._asdict().items():
                assert torch.equal(getattr(got, name), x.to(getattr(got, name).dtype)), (tps, name)
            ptn = action_to_ptn(n, a)
            assert nl.parse_ptn(n, ptn) == jax_nl.parse_ptn(n, ptn) == ptn_to_action(n, ptn) == a
            state = orc.step(state, a)
    with pytest.raises(ValueError, match="bad TPS"):
        nl.parse_tps(n, "x9 1 1")
    with pytest.raises(ValueError, match="bad PTN"):
        nl.parse_ptn(n, "ZZZ")


@pytest.mark.parametrize("return_lines", [False, True])
def test_parse_targets_matches_jax(return_lines):
    n = 4
    _, lines = _targets(n, 4, 3, seed=7, plies=10)
    text = "\n".join(lines) + "\n"
    got = nl.parse_targets(n, text, return_lines=return_lines)
    _expect_targets_equal(got, jax_nl.parse_targets(n, text, return_lines=return_lines))
    assert got[1].shape[0] == len(lines)
    for i, line in enumerate(lines):
        py = Target.from_line(n, line)
        assert (got[1][i], got[2][i]) == (np.float32(py.value), np.float32(py.ube))
        lo, hi = int(got[5][i]), int(got[5][i + 1])
        assert got[3][lo:hi].tolist() == [a for a, _ in py.policy]
        np.testing.assert_array_equal(got[4][lo:hi], np.array([p for _, p in py.policy], np.float32))


def test_parse_targets_skips_malformed():
    n = 4
    good = Target(tps="x4/x4/x4/2,x3 2 2", value=0.5, ube=1.0, policy=[(0, 1.0)], n=n).to_line()
    # A bad head, a short TPS, a bad move, a missing probability, a blank
    # line and trailing blanks and carriage returns around the good lines.
    text = ("garbage;;;\n" + good + " \r\nx4/x4 2 2;0;0;a1:1\n\n" + good.replace("a1", "z9") + "\n"
            + good.rsplit(":", 1)[0] + "\n" + good + "\n")
    got = nl.parse_targets(n, text, return_lines=True)
    _expect_targets_equal(got, jax_nl.parse_targets(n, text, return_lines=True))
    assert got[1].tolist() == [0.5, 0.5] and got[6].tolist() == [1, 6]
    assert nl.parse_targets(n, text, max_targets=1)[1].tolist() == [0.5]
    assert nl.valid_target_lines(n, text.split("\n")) == [good + " \r", good]


def test_fmt_shortest_float32_decimals():
    """The wire's floats: the shortest decimal that round-trips float32,
    as JAX's ``_fmt``; the C++ parse reads them back to the same bits."""
    values = [0.997, 0.5, 4.0, -1.0, 1 / 3, 0.123456789, 1e-5, -0.001, 3.9999998, 0.0, -0.0]
    for v in values:
        s = _fmt(np.float32(v))
        assert s == jax_fmt(np.float32(v))
        assert np.float32(float(s)) == np.float32(v) and len(s) <= 12, (v, s)
    assert _fmt(float("nan")) == "nan" and _fmt(np.float32(0.997)) == "0.997" and _fmt(4.0) == "4"
    text = "".join(Target(tps="x3/x3/x3 1 1", value=float(np.float32(v)), ube=0.0, policy=[(0, 1.0)],
                          n=3).to_line() + "\n" for v in values)
    np.testing.assert_array_equal(nl.parse_targets(3, text)[1], np.array(values, np.float32))


def _replay_lines(n, half_komi, games, seed, max_plies):
    _, _, _, played = _random_games(n, half_komi, games, seed, max_plies=max_plies)
    return [JaxReplay(tps=state_to_tps(n, start), actions=actions, result="R-0" if res >= 0 else "", n=n).to_line()
            for start, actions, res in played]


@pytest.mark.parametrize("n,half_komi", [(3, 0), (5, 4)])
def test_parse_replay_positions_matches_jax(n, half_komi):
    lines = _replay_lines(n, half_komi, 4, seed=11, max_plies=30)
    text = "\n".join(lines) + "\n"
    states, plies = nl.parse_replay_positions(n, half_komi, 50, text)
    jstates, jplies = jax_nl.parse_replay_positions(n, half_komi, 50, text)
    assert_state_equal(states, jstates)
    assert plies.dtype == np.int32 and plies.tolist() == np.asarray(jplies).tolist()
    eng = torch_engine(n, half_komi=half_komi)
    expected = [s for line in lines for s in Replay.from_line(n, line).states(eng)]
    assert len(expected) == states.height.shape[0]
    for i, exp in enumerate(expected):
        for name in exp._fields:
            assert torch.equal(getattr(states, name)[i], getattr(exp, name).to(getattr(states, name).dtype)), name
    rows, _ = nl.parse_replay_rows(n, half_komi, 50, text)
    assert_state_equal(nl.unpack_states(n, rows), jstates)


def test_parse_replays_rolls_back_malformed_lines():
    n = 3
    _, _, _, games = _random_games(n, 0, 2, seed=13, max_plies=20)
    start, actions, _ = games[0]
    good = JaxReplay(tps=state_to_tps(n, start), actions=actions[:6], result="", n=n).to_line()
    tokens = good.split(" ")
    bad = " ".join(tokens[:4] + ["ZZZ"] + tokens[4:])  # corrupt mid-game
    text = bad + "\nno replay\n" + '[TPS "x9 1 1"] a1\n' + good + "\n"
    states, plies = nl.parse_replay_positions(n, 0, 50, text)
    jstates, jplies = jax_nl.parse_replay_positions(n, 0, 50, text)
    assert states.height.shape[0] == 6
    assert_state_equal(states, jstates)
    assert plies.tolist() == np.asarray(jplies).tolist()


@pytest.mark.parametrize("augment,splits", [(False, None), (True, None), (True, 3)])
def test_make_batch_native_matches_jax(augment, splits):
    n = 3
    jeng, lines = _targets(n, 0, 3, seed=5, plies=8, uniform=not augment)
    lines = lines[:24]
    text = "\n".join(lines[:12]) + "\ngarbage;;;\n" + "\n".join(lines[12:]) + "\n"
    got = nl.make_batch_native(torch_engine(n, half_komi=0), text, np.random.default_rng(0), augment=augment,
                               splits=splits, device="cpu")
    want = jax_nl.make_batch_native(jeng, text, np.random.default_rng(0), augment=augment, splits=splits)
    for name in ("policy", "mask", "value", "ube"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # JAX builds the planes under jit, where the reserve ratios may be one
    # float32 ulp apart (tests/test_torch_data.py); every other channel is exact.
    np.testing.assert_allclose(got.planes.numpy(), np.asarray(want.planes), rtol=0, atol=1e-6)
    assert got.planes.shape[0] == (3 if splits else 24)


def test_make_batch_native_augment_consistent():
    n = 3
    t = Target(tps="x3/x3/2,1,x 1 2", value=0.1, ube=0.2,
               policy=[(ptn_to_action(n, "a3"), 0.75), (ptn_to_action(n, "b2"), 0.25)], n=n)
    text = "\n".join([t.to_line()] * 16) + "\n"
    batch = nl.make_batch_native(torch_engine(n), text, np.random.default_rng(5), device="cpu")
    pol = batch.policy.numpy()
    np.testing.assert_allclose(pol.sum(-1), 1.0, atol=1e-6)
    assert (batch.mask.numpy().sum(-1) == 2).all()
    for row in pol:
        assert sorted(row[row > 0].tolist()) == [0.25, 0.75]
