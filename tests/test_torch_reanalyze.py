"""The port's reanalyze actor against the JAX package's.

* Replay explosion: ``parse_replay_positions`` (the port's binding of its
  copy of the C++ loader) against JAX's on replays
  of JAX's own selfplay at 3x3 and 4x4, with malformed lines mixed in:
  states and plies exactly; ``pack_rows`` against JAX's.
* ``PositionBuffer.sample`` picks JAX's rows for one seed.
* ``make_reanalyze_step`` against JAX's, its Gumbel draw rebuilt from the
  same key (``torch_parity.search_draws``): actions, child actions and
  incomplete bits exactly; value, policy and UBE to 1e-6 with the dummy
  evaluator and 1e-4 with the bridged float32 tiny3 network.
* ``build_targets`` with C=4: truncated roots padded through the port's
  engine equal JAX's padded through the C++ oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.config import selfplay_preset as jax_selfplay_preset
from takzero_tpu.data import native_loader as jax_nl
from takzero_tpu.data.buffer import PositionBuffer as JaxPositionBuffer
from takzero_tpu.drivers.reanalyze import pack_rows as jax_pack_rows
from takzero_tpu.models.agent import make_net_evaluate as jax_net_evaluate
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.reanalyze import build_targets as jax_build_targets
from takzero_tpu.reanalyze import make_reanalyze_step as jax_reanalyze_step
from takzero_tpu.search.agents import dummy_evaluator as jax_dummy
from takzero_tpu.search.agents import simple_evaluator as jax_simple
from takzero_tpu.search.openings import make_new_opening as jax_opening
from takzero_tpu.selfplay import SelfplayEngine as JaxSelfplay
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import state_to_tps as jax_state_to_tps
from takzero_tpu.tak.oracle import Oracle
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.data import native_loader as nl
from takzero_torch.data.buffer import PositionBuffer
from takzero_torch.drivers.reanalyze import explode_replays, pack_rows
from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.reanalyze import build_targets, make_reanalyze_step
from takzero_torch.search.agents import dummy_evaluator, simple_evaluator
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tak.tps import state_to_tps

from torch_parity import assert_state_equal, search_draws, state_to_torch

torch.set_num_threads(2)

BATCH, BUDGET, K, C = 4, 16, 4, 32


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _jax_selfplay_replays(n: int, games: int) -> list[str]:
    """Replay and exploration-replay lines of JAX's selfplay (dummy
    evaluator, batch 8)."""
    net = {3: "tiny3", 4: "net4_simhash"}[n]
    eng = jax_engine(n, half_komi=JAX_PRESETS[net].half_komi)
    cfg = jax_selfplay_preset(net, batch=8, search_budget=8, sampled_actions=2, max_children=16,
                              exploration=True)
    sp = JaxSelfplay(eng, cfg, lambda bundle, e: jax_dummy(eng)(e))
    sp.reset(jax.random.PRNGKey(n))
    lines, finished, key = [], 0, jax.random.PRNGKey(10 + n)
    while finished < games:
        key, k = jax.random.split(key)
        _, replays, exploration = sp.play_move({}, k)
        finished += len(replays)
        lines += [r.to_line() for r in replays + exploration]
    return lines


@pytest.fixture(scope="module")
def replays3():
    return _jax_selfplay_replays(3, 8)


MALFORMED = [
    "",
    "not a replay",
    '[TPS "x3/x3/x3 1 1"]',  # no moves
    '[TPS "x3/x3/x3 1 1"] a1 zz9 b2',  # a bad move: the whole line goes
    '[TPS "x4/x3/x3 1 1"] a1 b2',  # a bad TPS
    '[TPS "x3/x3/x3 1 1" a1 b2',  # no closing "]
    '[TPS "x3/x3/x3 1 1"] a1 b2 R-0 c3',  # tokens after a result are ignored
    '[TPS "x3/x3/x3 1 1"]  a1  c3 \r',  # extra spaces and a carriage return
]


@pytest.mark.parametrize("n", [3, 4])
def test_replay_explosion_matches_jax(n, replays3):
    lines = replays3 if n == 3 else _jax_selfplay_replays(4, 8)
    if n == 3:
        lines = MALFORMED[:4] + lines + MALFORMED[4:]
    text = "\n".join(lines) + "\n"
    half_komi = JAX_PRESETS["tiny3" if n == 3 else "net4_simhash"].half_komi
    jstates, jplies = jax_nl.parse_replay_positions(n, half_komi, 50, text)
    states, plies = nl.parse_replay_positions(n, half_komi, 50, text)
    assert len(plies) == len(jplies) > 40
    np.testing.assert_array_equal(plies, jplies)
    assert_state_equal(states, jstates, f"{n}x{n} exploded replays")
    rows = pack_rows(n, states)
    np.testing.assert_array_equal(rows, jax_pack_rows(n, jstates))
    assert_state_equal(nl.unpack_states(n, rows), jstates, "unpacked rows")
    eng = torch_engine(n, half_komi=half_komi)
    np.testing.assert_array_equal(np.stack(explode_replays(eng, lines)), rows)
    assert explode_replays(eng, []) == [] and len(nl.parse_replay_positions(n, half_komi, 50, "")[1]) == 0


def test_position_buffer_picks_jax_rows():
    items = list(range(50))
    ours, theirs = PositionBuffer(np.random.default_rng(7), max_len=40), JaxPositionBuffer(
        np.random.default_rng(7), max_len=40)
    for buf in (ours, theirs):
        buf.extend(items[:30])
        buf.extend(items[30:])
    assert len(ours) == len(theirs) == 40
    for k in (5, 40, 64, 0):
        assert ours.sample(k) == theirs.sample(k)


def _positions(replays3, count: int):
    """The first ``count`` exploded positions with plies >= 2 (JAX's states
    and their TPS strings)."""
    text = "\n".join(replays3) + "\n"
    states, plies = jax_nl.parse_replay_positions(3, 0, 50, text)
    idx = np.flatnonzero(plies >= 2)[:count]
    return jax.tree.map(lambda x: np.asarray(x)[idx], states)


def _network():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny3"], compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    jbundle = jax_new_agent(jcfg, seed=3)
    tagent = from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")
    return jax_net_evaluate(jcfg, jax_engine(3)), make_net_evaluate(tcfg, torch_engine(3), device="cpu"), jbundle, tagent


@pytest.mark.parametrize("evaluator", ["dummy", "network"])
def test_reanalyze_step_matches_jax(evaluator, replays3):
    jeng, teng = jax_engine(3), torch_engine(3)
    if evaluator == "dummy":
        jf, tf, jb, tb, tol = (lambda b, e: jax_dummy(jeng)(e)), (lambda b, e: dummy_evaluator(teng)(e)), None, None, 1e-6
    else:
        (jf, tf, jb, tb), tol = _network(), 1e-4
    jstep = jax.jit(jax_reanalyze_step(jeng, jf, K, BUDGET, C, 16))
    tstep = make_reanalyze_step(teng, tf, K, BUDGET, C, 16)
    envs = _positions(replays3, 2 * BATCH)
    for i, key in enumerate((jax.random.PRNGKey(3), jax.random.PRNGKey(4))):
        part = jax.tree.map(lambda x: x[i * BATCH:(i + 1) * BATCH], envs)
        jout = [np.asarray(x) for x in jstep(jax.tree.map(jnp.asarray, part), jb, key)]
        tout = [x.numpy() for x in tstep(state_to_torch(part), tb, search_draws(key, BATCH, C))]
        names = ("action", "policy", "child_actions", "ube", "value", "incomplete")
        for name, t, j in zip(names, tout, jout):
            if name in ("policy", "ube", "value"):
                np.testing.assert_allclose(t, j, rtol=tol, atol=tol, err_msg=f"{evaluator} {i}: {name}")
            else:
                np.testing.assert_array_equal(t, j, err_msg=f"{evaluator} {i}: {name}")
        assert (jout[2] >= 0).sum(-1).min() > 0


def test_build_targets_pads_truncated_roots_as_jax():
    """C=4 with the simple evaluator (the set-up of
    ``tests/test_truncation_targets.py``); JAX pads through its oracle."""
    jeng, teng = jax_engine(3), torch_engine(3)
    jstep = jax.jit(jax_reanalyze_step(jeng, lambda b, e: jax_simple(jeng)(e), sampled_actions=4,
                                       search_budget=16, max_children=4, max_depth=16))
    tstep = make_reanalyze_step(teng, lambda b, e: simple_evaluator(teng)(e), sampled_actions=4,
                                search_budget=16, max_children=4, max_depth=16)
    envs = jax.tree.map(np.asarray, jax_opening(jeng, random_steps=3)(jax.random.PRNGKey(2), 4))
    tps = [jax_state_to_tps(3, jax.tree.map(lambda x: x[i], envs)) for i in range(4)]
    tenvs = state_to_torch(envs)
    assert [state_to_tps(3, tenvs.map(lambda x: x[i])) for i in range(4)] == tps
    key = jax.random.PRNGKey(3)
    jout = jstep(jax.tree.map(jnp.asarray, envs), {}, key)
    tout = tstep(tenvs, None, search_draws(key, 4, 4))
    assert np.asarray(jout[5]).any()
    want = jax_build_targets(3, tps, *jout[1:5], incomplete=jout[5], oracle=Oracle(3, 0))
    got = build_targets(3, tps, *tout[1:5], incomplete=tout[5], eng=teng)
    assert len(got) == len(want) == 4
    padded = 0
    for a, b in zip(got, want):
        assert a.tps == b.tps and [x for x, _ in a.policy] == [x for x, _ in b.policy]
        np.testing.assert_allclose([p for _, p in a.policy], [p for _, p in b.policy], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose([a.value, a.ube], [b.value, b.ube], rtol=1e-6, atol=1e-6)
        padded += len(a.policy) > 4
    assert padded > 0
    # Without the engine nothing is padded.
    assert [len(t.policy) for t in build_targets(3, tps, *tout[1:5])] == [
        int((tout[2][i] >= 0).sum()) for i in range(4)]
