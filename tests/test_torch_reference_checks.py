"""The JAX package's checks against the reference system itself, run on the
port: no JAX import, only files of the repository.

* ``tests/test_reference_runs_fixtures.py``: 1,024 root tables that the
  reference (takzero + fast-tak) dumped at 5x5
  (``tests/data/reference_run_puct.txt``): every PTN token round-trips
  through the port's action space, flats and walls are placeable on the
  same squares and capstones on none or all of them, and every spread
  family is exactly one that the port's engine makes on a constructed
  position, with one (height, cap) explaining all directions of an
  origin.  (The branch that reads the reference's own tree is JAX's.)
* ``tests/test_descend_invariants.py``: 24 moves of in-place reuse
  (``descend_batch``/``reset_lanes``) on a tight pool, checked after every
  move against a host BFS over the child links.
* ``tests/test_safecrack.py``: a never-ending SafeCrack game through the
  port's ``make_kernels`` pushes a positive discounted value to the root
  and a negative one onto the key digit, and leaves wrong digits at 0.
  The key has 2 digits (JAX's 3, the reference's 5) and each stage 505
  simulations (JAX's 12,601): the port's search runs eagerly on the CPU.
* ``tests/test_eval_order.py``: the eval total order (reference
  eval.rs:169-194), argmin/argmax and negation.
* ``tests/test_repr.py``: the golden input planes (reference
  repr.rs:260-409), the 5x5 position against an independent TPS walker.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

from takzero_torch.ops.repr import input_channels, stack_size, state_to_planes
from takzero_torch.search import eval as ev
from takzero_torch.search.agents import simple_evaluator
from takzero_torch.search.core import make_kernels
from takzero_torch.search.openings import make_new_opening
from takzero_torch.search.policy import slot_action
from takzero_torch.search.tree import descend_batch, init_tree, reset_lanes
from takzero_torch.selfplay import gumbel_noise
from takzero_torch.tak.engine import engine
from takzero_torch.tak.moves import DEFAULT_RESERVES, action_space, action_to_ptn, ptn_to_action
from takzero_torch.tak.state import where_state
from takzero_torch.tak.tps import tps_to_state

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# Recorded fast-tak root tables (tests/test_reference_runs_fixtures.py)
# ---------------------------------------------------------------------------

N = 5
FIXTURE = pathlib.Path(__file__).parent / "data" / "reference_run_puct.txt"


@pytest.fixture(scope="module")
def lines():
    out = []
    for line in FIXTURE.read_text().splitlines():
        keys = [m.split(":")[0] for m in line.split(",") if m]
        assert keys, "empty line in fixture"
        out.append(keys)
    assert len(out) == 1024
    return out


def decompose(a: int):
    """action index -> ('place', kind, sq) | ('spread', sq, dir, mask)."""
    sp = action_space(N)
    ch, sq = divmod(a, sp.num_squares)
    if ch < 3:
        return ("place", ch, sq)
    d, m = divmod(ch - 3, sp.num_patterns)
    return ("spread", sq, d, m + 1)


def test_ptn_round_trip(lines):
    seen = {k for keys in lines for k in keys}
    assert len(seen) > 1000  # placements, spreads, crushes
    for k in seen:
        a = ptn_to_action(N, k)
        assert 0 <= a < action_space(N).num_actions
        assert action_to_ptn(N, a) == k


def test_placement_consistency(lines):
    for i, keys in enumerate(lines):
        flats, walls, caps = set(), set(), set()
        for k in keys:
            kind = decompose(ptn_to_action(N, k))
            if kind[0] == "place":
                (flats, walls, caps)[kind[1]].add(kind[2])
        assert flats == walls, f"line {i}: flat/wall placement sets differ"
        assert caps == set() or caps == flats, f"line {i}: capstone placements are neither none nor all"


def build_tps(m: int, cap_top: bool, r: int, blocker: str | None) -> str:
    """A mover stack of height m at a1, r free squares above it, then an
    opponent wall or cap when ``blocker`` is set; player 1 to move."""
    col_a = [""] * N
    col_a[0] = "2" * (m - 1) + "1" + ("C" if cap_top else "")
    if blocker is not None:
        assert r < N - 1
        col_a[r + 1] = {"wall": "2S", "cap": "2C"}[blocker]
    rows = []
    for rank in range(N - 1, -1, -1):
        rows.append(",".join(col_a[rank] if c == 0 and col_a[rank] else "x" for c in range(N)))
    return "/".join(rows) + " 1 10"


@pytest.fixture(scope="module")
def family_table():
    """{frozenset(masks): [(m, cap_top, r, blocker), ...]} from the port's
    engine: the spread patterns it allows from a1 upwards."""
    eng = engine(N)
    geometries = [(m, cap_top, r, blocker) for m in range(1, 6) for cap_top in (False, True)
                  for r in range(N) for blocker in ([None] if r >= N - 1 else ["wall", "cap"])]
    states = [tps_to_state(N, build_tps(*g)) for g in geometries]
    batch = type(states[0])(*(torch.stack(x) for x in zip(*states)))
    legal = eng.legal_mask(batch).numpy()
    table: dict[frozenset, list] = {}
    for g, mask in zip(geometries, legal):
        masks = frozenset(d[3] for a in np.nonzero(mask)[0]
                          if (d := decompose(int(a)))[0] == "spread" and d[1] == 0 and d[2] == 0)
        table.setdefault(masks, []).append(g)
    return table


def room_of(sq: int, d: int) -> int:
    row, col = divmod(sq, N)
    return [N - 1 - row, N - 1 - col, row, col][d]


def crushes(masks: frozenset, r: int) -> bool:
    """Does a pattern of the family reach square r+1 (a wall crush)?"""
    sp = action_space(N)
    return any(int(np.count_nonzero(sp.spread_drops[m - 1])) > r for m in masks)


def test_spread_families(lines, family_table):
    checked = 0
    for i, keys in enumerate(lines):
        families: dict[tuple, set] = {}
        for k in keys:
            d = decompose(ptn_to_action(N, k))
            if d[0] == "spread":
                families.setdefault((d[1], d[2]), set()).add(d[3])
        by_origin: dict[int, list[set]] = {}
        for (sq, dirn), masks in families.items():
            room = room_of(sq, dirn)
            cfgs = [cfg for cfg in family_table.get(frozenset(masks), [])
                    if cfg[2] <= room and (cfg[2] < room or cfg[3] != "wall" or not crushes(frozenset(masks), cfg[2]))]
            assert cfgs, f"line {i}: spread family at sq={sq} dir={dirn} (room {room}) not reproducible: {sorted(masks)}"
            by_origin.setdefault(sq, []).append({(m, c) for m, c, _, _ in cfgs})
            checked += 1
        for sq, explanations in by_origin.items():
            assert set.intersection(*explanations), f"line {i}: no single (height, cap) explains sq={sq}"
    assert checked > 2000


# ---------------------------------------------------------------------------
# In-place reuse over many moves (tests/test_descend_invariants.py)
# ---------------------------------------------------------------------------


def bfs_live(cn):
    seen, stack = {0}, [0]
    while stack:
        for child in cn[stack.pop()]:
            c = int(child)
            if c >= 0 and c not in seen:
                seen.add(c)
                stack.append(c)
    return seen


def check_invariants(tree, lane):
    m = tree.node_parent.shape[1]
    cn = tree.child_node[lane].numpy()
    par, slot = tree.node_parent[lane].numpy(), tree.node_slot[lane].numpy()
    live, free_rows = tree.node_live[lane].numpy(), tree.free_rows[lane].numpy()
    a0, fc = int(tree.alloc_ptr[lane]), int(tree.free_count[lane])
    reach = bfs_live(cn)
    live_set = set(np.nonzero(live)[0].tolist())
    assert live_set == reach, (sorted(live_set - reach), sorted(reach - live_set))
    assert int(tree.node_count[lane]) == len(reach)
    assert m - 1 not in reach  # the scratch row is never linked
    for s in reach - {0}:
        p = int(par[s])
        assert p in reach, (s, p)
        assert int(cn[p, int(slot[s])]) == s, (s, p, int(slot[s]))
    assert int(par[0]) == -1
    free_seg = set(free_rows[a0:fc].tolist())
    assert not (free_seg & reach), sorted(free_seg & reach)
    assert m - 1 not in free_seg


def test_many_move_reuse_invariants():
    eng = engine(3)
    simulate, simulate_batch = make_kernels(eng, simple_evaluator(eng), max_depth=12)
    budget, lanes = 24, 3
    gen = torch.Generator().manual_seed(0)

    def opening():
        sym, pair = torch.randint(0, 8, (lanes,), generator=gen), torch.randint(0, 2, (lanes,), generator=gen)
        return make_new_opening(eng, random_steps=1)(sym, pair, gumbel_noise(gen, (1, lanes, eng.num_actions)))

    envs = opening()
    # A tight pool: budget + a small carry headroom, so that the free list
    # recycles rows and min_headroom resets lanes.
    tree = init_tree(eng, envs, budget + 12, 48)
    zero = torch.zeros(lanes)
    resets = 0
    for _ in range(24):
        tree = simulate_batch(simulate(tree, zero), zero, budget - 1)
        for lane in range(lanes):
            check_invariants(tree, lane)
        cv, cn0, ca = (x[:, 0, :] for x in (tree.child_visit, tree.child_node, tree.child_action))
        slots = torch.where((cn0 >= 0) & (ca >= 0), cv, -1).argmax(1).to(torch.int32)
        stepped = eng.step(envs, slot_action(tree, slots).clamp(min=0))
        done = eng.terminal_kind(stepped) != 0
        nxt = where_state(done, opening(), stepped)
        tree, ok = descend_batch(tree, slots, min_headroom=budget, max_chain=12)
        resets += int((~ok | done).sum())
        tree = reset_lanes(tree, done | ~ok, nxt)
        envs = nxt
        for lane in range(lanes):
            check_invariants(tree, lane)
    # The premise: some carries and some resets over 24 moves x 3 lanes.
    assert 0 < resets < 24 * lanes


# ---------------------------------------------------------------------------
# SafeCrack: discounted values through the search (tests/test_safecrack.py)
# ---------------------------------------------------------------------------

KEY = (0, 1)
MAXLEN = 8
CRACK_ACTIONS = 11  # digits 0-9 and the forced no-op


class CrackState(NamedTuple):
    tried: torch.Tensor  # int32[B, MAXLEN]
    length: torch.Tensor  # int32[B]
    active: torch.Tensor  # int32[B], 1: the cracker moves
    ply: torch.Tensor  # int32[B]

    def map(self, fn) -> "CrackState":
        return CrackState(*(fn(x) for x in self))


class SafeCrackEngine:
    """A never-ending game: the cracker enters a digit on active plies, the
    other side passes (action 10) on the rest."""

    num_actions = CRACK_ACTIONS

    def initial(self, batch: int) -> CrackState:
        i32 = dict(dtype=torch.int32)
        return CrackState(torch.full((batch, MAXLEN), -1, **i32), torch.zeros(batch, **i32),
                          torch.ones(batch, **i32), torch.zeros(batch, **i32))

    def step(self, s: CrackState, action: torch.Tensor) -> CrackState:
        active = s.active == 1
        rows, col = torch.arange(s.tried.shape[0]), s.length.clamp(max=MAXLEN - 1).long()
        tried = s.tried.clone()
        tried[rows, col] = torch.where(active, action.to(torch.int32), tried[rows, col])
        return CrackState(tried, s.length + active.to(torch.int32), 1 - s.active, s.ply + 1)

    def legal_mask(self, s: CrackState) -> torch.Tensor:
        a = torch.arange(CRACK_ACTIONS)
        return torch.where((s.active == 1)[:, None], a < 10, a == 10)

    def terminal_kind(self, s: CrackState) -> torch.Tensor:
        return torch.zeros_like(s.ply)


def safecracker_evaluator(eng):
    """+1 for the side to move when it is the cracker and the key is in,
    -1 for the other side then, 0 otherwise."""
    key = torch.tensor(KEY, dtype=torch.int32)

    def evaluate(envs: CrackState):
        logits = torch.where(eng.legal_mask(envs), 1.0, -1e9)
        solved = (envs.length >= len(KEY)) & (envs.tried[:, : len(KEY)] == key).all(-1)
        value = torch.where(envs.active == 1, 1.0, -1.0) * solved.float()
        return logits, value, torch.zeros_like(value)

    return evaluate


def test_safe_cracker_value_propagation():
    eng = SafeCrackEngine()
    simulate, simulate_batch = make_kernels(eng, safecracker_evaluator(eng), max_depth=2 * len(KEY) + 4)
    env = eng.initial(1)
    zero = torch.zeros(1)
    for k in KEY:
        tree = simulate(init_tree(None, env, max_nodes=520, max_children=CRACK_ACTIONS), zero)
        for _ in range(8):
            tree = simulate_batch(tree, zero, 63)
        assert float(tree.root_value[0]) > 0.0, f"stage {k}: root {float(tree.root_value[0])}"
        for a, v, n in zip(*(x[0, 0].tolist() for x in (tree.child_action, tree.child_value, tree.child_visit))):
            if a < 0:
                continue
            if a == k:
                assert v < 0.0, f"key child {a}: {v} (visits {n})"
            else:
                assert abs(v) < 0.05, f"child {a}: {v}"  # wrong digits never reach the key
        # Play the key digit and the forced no-op, as the reference descends.
        env = eng.step(eng.step(env, torch.tensor([k])), torch.tensor([10]))


# ---------------------------------------------------------------------------
# The eval total order (tests/test_eval_order.py)
# ---------------------------------------------------------------------------


def _keys(items):
    flag = torch.tensor([f for f, _, _ in items], dtype=torch.int32)
    ply = torch.tensor([p for _, p, _ in items], dtype=torch.int32)
    val = torch.tensor([v for _, _, v in items], dtype=torch.float32)
    prim, sec = ev.order_keys(flag, ply, val)
    return list(zip(prim.tolist(), sec.tolist()))


def test_eval_order_matches_reference():
    V, W, L, D = ev.VALUE, ev.WIN, ev.LOSS, ev.DRAW
    evals = [(V, 0, 1.0), (V, 0, ev.CONTEMPT + 0.1), (V, 0, -1.0), (W, 5, 0.0), (W, 10, 0.0), (D, 5, 0.0),
             (D, 10, 0.0), (L, 5, 0.0), (L, 10, 0.0)]
    expected = [(L, 5, 0.0), (L, 10, 0.0), (V, 0, -1.0), (D, 10, 0.0), (D, 5, 0.0), (V, 0, ev.CONTEMPT + 0.1),
                (V, 0, 1.0), (W, 10, 0.0), (W, 5, 0.0)]
    assert sorted(evals, key=lambda e: _keys([e])[0]) == expected


def test_argmin_argmax_respect_order():
    V, W, L, D = ev.VALUE, ev.WIN, ev.LOSS, ev.DRAW
    flag = torch.tensor([[W, L, V, D, L]], dtype=torch.int32)
    ply = torch.tensor([[3, 7, 0, 2, 2]], dtype=torch.int32)
    val = torch.tensor([[0.0, 0.0, 0.3, 0.0, 0.0]])
    valid = torch.ones((1, 5), dtype=torch.bool)
    # Worst: the earliest loss (ply 2, index 4); best: the win.
    assert int(ev.argmin_eval(flag, ply, val, valid)[0]) == 4
    assert int(ev.argmax_eval(flag, ply, val, valid)[0]) == 0
    valid[0, 0] = False
    assert int(ev.argmax_eval(flag, ply, val, valid)[0]) == 2  # then the best value


def test_negate_and_float():
    f, p, v = ev.negate(torch.tensor(ev.WIN), torch.tensor(0), torch.tensor(0.0))
    assert int(f) == ev.LOSS and int(p) == 1
    assert abs(float(ev.eval_to_float(f, p, v)) + ev.DISCOUNT) < 1e-6
    assert abs(ev.SERIES_DISCOUNT - 1.0 / (1.0 - 0.997**2)) < 1e-9


# ---------------------------------------------------------------------------
# Golden input planes (tests/test_repr.py)
# ---------------------------------------------------------------------------


def planes(n, half_komi, tps=None):
    eng = engine(n, half_komi=half_komi)
    state = eng.initial(1) if tps is None else tps_to_state(n, tps).map(lambda x: x[None])
    return state_to_planes(eng, state)[0].numpy()


def expected_from_tps(n, half_komi, tps):
    """An independent encoder: walks the TPS text."""
    board_part, to_move_s, _ = tps.rsplit(" ", 2)
    me = int(to_move_s) - 1
    ss = stack_size(n)
    out = np.zeros((input_channels(n), n, n), np.float32)
    used, flats, cap_used = [0, 0], [0, 0], [0, 0]
    for i, row in enumerate(board_part.split("/")):
        r, c = n - 1 - i, 0
        for token in row.split(","):
            if token.startswith("x"):
                c += int(token[1:] or 1)
                continue
            mod = token[-1] if token[-1] in "SC" else ""
            colors = [int(d) - 1 for d in (token[:-1] if mod else token)]  # bottom to top
            for col in colors:
                used[col] += 1
            if mod == "C":
                cap_used[colors[-1]] += 1
            piece = {"": 0, "S": 1, "C": 2}[mod]
            if piece == 0:
                flats[colors[-1]] += 1
            out[(0 if colors[-1] == me else ss) + piece, r, c] = 1.0
            for d, col in enumerate(list(reversed(colors))[1:][: ss - 3]):  # top-down below the top
                out[(0 if col == me else ss) + 3 + d, r, c] = 1.0
            c += 1
    stones, caps = DEFAULT_RESERVES[n]
    out[2 * ss + 0] = (stones - (used[me] - cap_used[me])) / stones
    out[2 * ss + 1] = (caps - cap_used[me]) / caps if caps else 0.0
    out[2 * ss + 2] = (stones - (used[1 - me] - cap_used[1 - me])) / stones
    out[2 * ss + 3] = (caps - cap_used[1 - me]) / caps if caps else 0.0
    out[2 * ss + 4] = float(me == 1)
    out[2 * ss + 5] = (flats[0] - flats[1] - half_komi / 2.0) / (n * n)
    return out


def test_starting_position():
    got = planes(3, 0)
    ss = stack_size(3)
    expected = np.zeros_like(got)
    expected[2 * ss + 0] = 1.0  # my stones ratio
    expected[2 * ss + 2] = 1.0  # the opponent's
    assert got.shape == (input_channels(3), 3, 3)
    np.testing.assert_array_equal(got, expected)


def test_complicated_position():
    tps = "x2,1221,x,1S/2,2C,2,1,x/x,212,21C,2S,2/2211S,2,21,1,1/x2,221S,2,x 2 23"
    got = planes(5, 4, tps)
    np.testing.assert_allclose(got, expected_from_tps(5, 4, tps), rtol=0, atol=1e-6)
    # Literal spot checks from the reference's handmade tensor (repr.rs:311-351).
    ss = stack_size(5)
    assert got[2 * ss + 5, 0, 0] == np.float32(-3.0 / 25.0)  # flat difference
    assert got[2 * ss + 0, 0, 0] == np.float32(5.0 / 21.0)  # my (black) stones
    assert got[2 * ss + 2, 0, 0] == np.float32(10.0 / 21.0)  # the opponent's
    assert got[2 * ss + 4].all()  # black to move
    assert got[2, 3, 1] == 1.0  # my cap (2C on rank 4, column b)
    assert got[ss + 2, 2, 2] == 1.0  # the opponent's cap (21C)
    mine_flats = np.zeros((5, 5), np.float32)
    for r, c in [(0, 3), (1, 1), (2, 1), (2, 4), (3, 0), (3, 2)]:
        mine_flats[r, c] = 1.0
    np.testing.assert_array_equal(got[0], mine_flats)


def test_tall_stack():
    got = planes(3, -1, "x3/x,21212112212S,x/x3 1 12")
    expected = np.zeros_like(got)
    # White to move; the stack's top is a black wall at (r1, c1).  White's
    # carry planes at depths 1, 4, 5 -> channels 3, 6, 7; black's wall top
    # channel 10 and carries at depths 2, 3, 6 -> 13, 14, 17.
    for ch in (3, 6, 7, 10, 13, 14, 17):
        expected[ch, 1, 1] = 1.0
    expected[18] = 5.0 / 10.0  # my stones
    expected[20] = 4.0 / 10.0  # the opponent's
    expected[23] = 0.5 / 9.0  # the flat difference with komi -0.5
    np.testing.assert_allclose(got, expected, atol=1e-6)
