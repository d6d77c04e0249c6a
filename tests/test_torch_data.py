"""The port's learner data path against the JAX package.

* TPS: ``state_to_tps`` equals JAX's on random and tall-stack positions
  and ``tps_to_state`` round-trips, exact strings and exact fields.
* Symmetry tables: ``direction_maps`` and ``action_maps`` equal JAX's.
* ``Target.to_line`` / ``from_line``: exact bytes both ways.
* ``make_batch_native`` with the same numpy seed as JAX's (which parses
  through the prebuilt C++ library): policy, mask, value and ube exactly
  equal, with ``splits`` and with malformed lines dropped.  The planes
  equal JAX's ``state_to_planes`` run op by op on the same augmented
  states exactly; JAX's ``make_batch_native`` runs it under ``jit``, where
  XLA turns the reserve ratios' division by a constant into a
  multiplication by its reciprocal, so there the four reserve channels
  may differ by one float32 ulp and every other channel is exact.
* ``TargetBuffer`` and ``Tailer``: the same drains and reads as JAX's on
  the same operations.
* ``random_pretraining_targets`` on the port's engine: valid targets (a
  uniform policy over exactly the legal moves, discounted terminal values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.data import native_loader as jax_loader
from takzero_tpu.data.buffer import TargetBuffer as JaxBuffer
from takzero_tpu.data.target import Target as JaxTarget
from takzero_tpu.ops import repr as jax_repr
from takzero_tpu.parallel import coordinator as jax_co
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import state_to_tps as jax_state_to_tps
from takzero_tpu.tak import symmetry as jax_symmetry
from takzero_tpu.train.data import random_pretraining_targets as jax_random_targets
from takzero_torch.data import native_loader as torch_loader
from takzero_torch.data.buffer import TargetBuffer
from takzero_torch.data.target import Target
from takzero_torch.ops import repr as torch_repr
from takzero_torch.parallel import coordinator as co
from takzero_torch.search import eval as ev
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tak import symmetry as torch_symmetry
from takzero_torch.tak.tps import state_to_tps, tps_to_state
from takzero_torch.train.data import random_pretraining_targets

from torch_parity import assert_state_equal, state_to_torch, tall_states

torch.set_num_threads(2)


def _jax_lines(n: int, count: int, seed: int) -> list[str]:
    eng = jax_engine(n, half_komi=4 if n > 3 else 0)
    targets = jax_random_targets(eng, count, np.random.default_rng(seed))
    return [t.to_line() for t in targets]


def _lane(state, i):
    return state.map(lambda x: x[i])


@pytest.mark.parametrize("n", [3, 4, 6])
def test_tps_matches_jax(n):
    js = tall_states(n, 6, seed=n)
    ts = state_to_torch(js)
    for i in range(6):
        jlane = type(js)(*(np.asarray(x)[i] for x in js))
        tps = state_to_tps(n, _lane(ts, i))
        assert tps == jax_state_to_tps(n, jlane)
        back = tps_to_state(n, tps)
        # TPS carries no reserves or reversible count; the rest round-trips.
        for name in ("height", "owner", "tops", "to_move"):
            assert torch.equal(getattr(back, name), getattr(_lane(ts, i), name)), name
    for line in _jax_lines(n, 40, seed=n):
        tps = line.split(";")[0]
        assert state_to_tps(n, tps_to_state(n, tps)) == tps
        want = jax_loader.parse_tps(n, tps)
        got = tps_to_state(n, tps).map(lambda x: x[None])
        assert_state_equal(got, type(want)(*(np.asarray(x)[None] for x in want)), tps)


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_symmetry_tables_match_jax(n):
    np.testing.assert_array_equal(torch_symmetry.direction_maps(n), jax_symmetry.direction_maps(n))
    np.testing.assert_array_equal(torch_symmetry.action_maps(n), jax_symmetry.action_maps(n))


@pytest.mark.parametrize("n", [3, 6])
def test_target_lines_match_jax_bytes(n):
    lines = _jax_lines(n, 30, seed=10 + n)
    rng = np.random.default_rng(0)
    odd = [0.1, -0.0, 1e-8, 0.99700004, float("nan"), float("inf"), 3.9999998, 2.0**-20]
    for i, line in enumerate(lines):
        t, jt = Target.from_line(n, line), JaxTarget.from_line(n, line)
        assert (t.tps, t.value, t.ube, t.policy) == (jt.tps, jt.value, jt.ube, jt.policy)
        assert t.to_line() == jt.to_line() == line
        # Values the wire format must print as JAX does.
        v = odd[i % len(odd)]
        p = [(a, float(rng.random())) for a, _ in t.policy]
        t2 = Target(tps=t.tps, value=v, ube=float(rng.random() * 4), policy=p, n=n)
        jt2 = JaxTarget(tps=t.tps, value=v, ube=t2.ube, policy=p, n=n)
        assert t2.to_line() == jt2.to_line()


def _assert_batch_equal(n, got, want, text, seed, augment=True):
    for name, g, w in zip(("policy", "mask", "value", "ube"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # Planes: exact against JAX's encoder op by op on the same states ...
    states = jax_loader.parse_targets(n, text)[0]
    t = states.height.shape[0]
    syms = np.random.default_rng(seed).integers(0, 8, size=t) if augment else np.zeros(t, np.int64)
    states = jax_loader.augment_states(n, states, syms.astype(np.int32))
    eng = jax_engine(n, half_komi=4 if n > 3 else 0)
    eager = np.asarray(jax.vmap(lambda s: jax_repr.state_to_planes(eng, s))(jax.tree.map(jnp.asarray, states)))
    got_planes = got.planes.numpy().reshape(eager.shape)
    np.testing.assert_array_equal(got_planes, eager, err_msg="planes vs state_to_planes")
    # ... and against the jitted batch encoder, exact but for one ulp of
    # the reserve ratios.
    jit_planes = np.asarray(want.planes).reshape(eager.shape)
    reserve = 2 * torch_repr.stack_size(n) + np.arange(4)
    other = np.setdiff1d(np.arange(eager.shape[1]), reserve)
    np.testing.assert_array_equal(got_planes[:, other], jit_planes[:, other], err_msg="planes")
    np.testing.assert_array_max_ulp(got_planes[:, reserve], jit_planes[:, reserve], maxulp=1)


@pytest.mark.parametrize("n", [3, 4, 6])
def test_make_batch_native_matches_jax(n):
    lines = _jax_lines(n, 48, seed=20 + n)
    malformed = [
        "",
        "garbage",
        lines[0].split(";")[0] + ";0.5;1",  # three fields
        "x,x/x,x;0;0;a1:1",  # wrong row count
        lines[1].rsplit(",", 1)[0] + ",z9:0.5",  # bad move
        lines[2].split(";")[0] + ";0.5;1;",  # empty policy
        "   ",
    ]
    mixed = []
    for i, line in enumerate(lines):
        mixed.append(line)
        if i % 7 == 3:
            mixed.append(malformed[(i // 7) % len(malformed)])
    text = "\n".join(mixed) + "\n"
    valid = torch_loader.valid_target_lines(n, mixed)
    assert valid == jax_loader.valid_target_lines(n, mixed) == lines
    teng, jeng = torch_engine(n, half_komi=4 if n > 3 else 0), jax_engine(n, half_komi=4 if n > 3 else 0)
    for augment in (True, False):
        got = torch_loader.make_batch_native(teng, text, np.random.default_rng(5), augment=augment, device="cpu")
        want = jax_loader.make_batch_native(jeng, text, np.random.default_rng(5), augment=augment)
        _assert_batch_equal(n, got, want, text, 5, augment)
    got = torch_loader.make_batch_native(teng, text, np.random.default_rng(6), splits=4, device="cpu")
    want = jax_loader.make_batch_native(jeng, text, np.random.default_rng(6), splits=4)
    assert got.planes.shape[:2] == (4, 12)
    _assert_batch_equal(n, got, want, text, 6)
    with pytest.raises(ValueError):
        torch_loader.make_batch_native(teng, text, np.random.default_rng(6), splits=5, device="cpu")
    with pytest.raises(ValueError):
        torch_loader.make_batch_native(teng, "garbage\n", np.random.default_rng(6), device="cpu")


def test_target_buffer_matches_jax():
    ours, theirs = TargetBuffer(np.random.default_rng(3)), JaxBuffer(np.random.default_rng(3))
    for buf in (ours, theirs):
        buf.extend([f"t{i}" for i in range(50)], 4, 1)
    drains_ours, drains_theirs = [], []
    for step in range(40):
        size = min(16 if step % 3 else 7, len(ours))
        if step == 10:
            ours.extend([f"u{i}" for i in range(9)], 2, step)
            theirs.extend([f"u{i}" for i in range(9)], 2, step)
        drains_ours.append(ours.drain_batch(size))
        drains_theirs.append(theirs.drain_batch(size))
        assert len(ours) == len(theirs)
    assert drains_ours == drains_theirs
    with pytest.raises(ValueError):
        ours.drain_batch(len(ours) + 1)


def test_tailer_and_buffer_lengths_match_jax(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ours, theirs = co.Tailer(a, co.TARGETS_SELFPLAY), jax_co.Tailer(b, jax_co.TARGETS_SELFPLAY)
    writes = [["l1", "l2"], ["l3"], None, ["much longer line than before " * 4], ["x"], "partial"]
    for w in writes:
        for d in (a, b):
            path = d / co.TARGETS_SELFPLAY
            if w is None:  # rewrite in place, same length: detected by the signature
                path.write_text(path.read_text().upper())
            elif w == "partial":  # a writer's unfinished line is not consumed
                with open(path, "a") as f:
                    f.write("half")
            elif w == ["x"]:  # truncation
                path.write_text("x\n")
            else:
                co.append_lines(d, co.TARGETS_SELFPLAY, w)
        assert ours.read_new_lines() == theirs.read_new_lines()
        assert ours.offset == theirs.offset
    co.write_buffer_lengths(a, 12, 3)
    assert jax_co.read_buffer_lengths(a) == co.read_buffer_lengths(a) == (12, 3)
    (a / co.BUFFER_LENGTHS).write_text("12,3,16")
    assert co.read_buffer_lengths(a) is None
    assert (co.TARGETS_SELFPLAY, co.TARGETS_REANALYZE, co.TARGETS_INITIAL, co.BUFFER_LENGTHS) == (
        jax_co.TARGETS_SELFPLAY, jax_co.TARGETS_REANALYZE, jax_co.TARGETS_INITIAL, jax_co.BUFFER_LENGTHS)


@pytest.mark.parametrize("n", [3, 4])
def test_random_pretraining_targets_are_valid(n):
    eng = torch_engine(n, half_komi=4 if n > 3 else 0)
    targets = random_pretraining_targets(eng, 120, np.random.default_rng(n), device="cpu")
    assert len(targets) == 120
    discounted = {round(ev.DISCOUNT**k, 6) for k in range(1, 402)}
    ends = 0
    for t in targets:
        state = tps_to_state(n, t.tps).map(lambda x: x[None])
        legal = np.flatnonzero(eng.legal_mask(state)[0].numpy())
        acts = [a for a, _ in t.policy]
        assert sorted(acts) == legal.tolist()
        probs = np.array([p for _, p in t.policy])
        assert np.all(probs == probs[0]) and abs(probs.sum() - 1.0) < 1e-6
        assert t.ube == pytest.approx(4.0 - np.finfo(np.float32).eps)
        assert t.value == 0.0 or round(abs(t.value), 6) in discounted
        if abs(t.value) == pytest.approx(ev.DISCOUNT):
            # One ply from the end: some legal move ends the game with
            # the mover's win (value > 0) or loss.
            nxt = eng.step(state.map(lambda x: x.expand(len(legal), *x.shape[1:])), torch.from_numpy(legal))
            kind = eng.terminal_kind(nxt).numpy()  # for the opponent, who moves next
            assert ((kind == 2) if t.value > 0 else (kind == 1)).any()
            ends += 1
    assert ends > 0
    # The lines are the JAX package's wire format.
    for t in targets[:20]:
        assert JaxTarget.from_line(n, t.to_line()).to_line() == t.to_line()
