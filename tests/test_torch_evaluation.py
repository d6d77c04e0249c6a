"""The port's pit fighter, evaluation driver and puzzle benchmark against
the JAX package's, with the supporting ``load_checkpoint_partial`` and
the RSS watchdog.

``compete`` and its half-move run on the bridged tiny3 network (float32 on
both sides) from JAX's openings with JAX's Gumbel draws (the
``jax.random.split`` chain of ``evaluation.py:138``, each key drawn as
``gumbel.py:88`` draws it).  Trees must equal JAX's after every half-move,
integers exactly outside the scratch row and floats within 1e-4 (the two
frameworks sum the convolutions in other orders, as in
``tests/test_torch_selfplay.py``); results must be equal.
"""

import dataclasses
import inspect
import logging
import sqlite3
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.drivers import puzzle as jax_puzzle
from takzero_tpu.evaluation import make_compete as jax_make_compete
from takzero_tpu.models.agent import make_net_evaluate as jax_net_evaluate
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.search.openings import make_new_opening as jax_opening
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tools.elo_curve import _MATCH
from takzero_tpu.tools.match_results import PATTERN
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.drivers import evaluation as eval_driver
from takzero_torch.drivers import learn, puzzle
from takzero_torch.evaluation import make_compete
from takzero_torch.models.agent import make_net_evaluate, new_agent
from takzero_torch.tak import engine as torch_engine
from takzero_torch.utils import ckpt, watchdog

from torch_parity import assert_state_equal, assert_tree_equal, state_to_torch

torch.set_num_threads(2)

FLOAT_TOL = {f: 1e-4 for f in ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")}
GAMES, K, BUDGET, CHILDREN, DEPTH = 4, 4, 16, 48, 16


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAKZERO_TOPK", "exact_ref")
        yield


def _pair(tree_reuse):
    """(JAX compete, port compete, JAX bundles, port bundles)."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny3"], compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    jb = [jax_new_agent(jcfg, seed=s) for s in (1, 2)]
    tb = [from_jax_bundle(jax.tree.map(np.asarray, b), tcfg, device="cpu") for b in jb]
    jc = jax_make_compete(jax_engine(3), jax_net_evaluate(jcfg, jax_engine(3)), K, BUDGET,
                          max_children=CHILDREN, max_depth=DEPTH, tree_reuse=tree_reuse)
    tc = make_compete(torch_engine(3), make_net_evaluate(tcfg, torch_engine(3), device="cpu"), K, BUDGET,
                      max_children=CHILDREN, max_depth=DEPTH, tree_reuse=tree_reuse)
    return jc, tc, jb, tb


def _jax_draws(key, half_moves):
    """Per half-move: the key JAX's compete passes to the search, and the
    Gumbel draw the search takes from it."""
    keys, draws = [], []
    for _ in range(half_moves):
        key, k = jax.random.split(key)
        keys.append(k)
        draws.append(torch.from_numpy(np.array(jax.random.gumbel(k, (GAMES, CHILDREN)))))
    return keys, draws


@pytest.mark.parametrize("tree_reuse", [True, False, (True, False)], ids=["reuse", "fresh", "reuse-white-only"])
def test_compete_matches_jax(tree_reuse):
    """Every half-move of a whole match, driven through both packages'
    ``half_move`` (JAX's jitted one from ``make_compete``'s closure), then
    ``compete`` itself: the same W/L/D."""
    jc, tc, jb, tb = _pair(tree_reuse)
    jhalf = inspect.getclosurevars(jc).nonlocals["half_move_jit"]
    reuse_w, reuse_b = tree_reuse if isinstance(tree_reuse, tuple) else (tree_reuse, tree_reuse)
    envs = jax_opening(jax_engine(3), random_steps=2)(jax.random.PRNGKey(0), GAMES)
    keys, draws = _jax_draws(jax.random.PRNGKey(1), 60)

    from takzero_tpu.search.tree import init_tree as jax_init
    from takzero_torch.search.tree import init_tree as torch_init

    nodes = BUDGET + 8 + min(384, BUDGET)
    jcur, tcur = envs, state_to_torch(envs)
    jt = [jax_init(jax_engine(3), jcur, nodes, CHILDREN) for _ in range(2)]
    tt = [torch_init(torch_engine(3), tcur, nodes, CHILDREN) for _ in range(2)]
    done = np.zeros(GAMES, bool)
    move = 0
    while not done.all() and move < 60:
        w = move % 2 == 0
        me, op = (0, 1) if w else (1, 0)
        mr, orr = (reuse_w, reuse_b) if w else (reuse_b, reuse_w)
        jcur, jtk, jt[me], jt[op] = jhalf(jcur, jb[me], keys[move], jnp.asarray(done), jt[me], jt[op],
                                          my_reuse=mr, opp_reuse=orr)
        tcur, ttk, tt[me], tt[op] = tc.half_move(tcur, tb[me], draws[move], torch.from_numpy(done),
                                                 tt[me], tt[op], mr, orr)
        where = f"half-move {move}"
        assert_state_equal(tcur, jcur, where)
        np.testing.assert_array_equal(ttk.numpy(), np.asarray(jtk), err_msg=where)
        for side in (0, 1):
            assert_tree_equal(tt[side], jt[side], f"{where}, tree {side}", FLOAT_TOL)
        done |= np.asarray(jtk) != 0
        move += 1
    assert done.all(), "every game ends within the test's 30 moves a side"

    jres = jc(jb[0], jb[1], envs, jax.random.PRNGKey(1), max_moves=30)
    tres = tc(tb[0], tb[1], state_to_torch(envs), max_moves=30, draws=draws)
    assert (tres.wins, tres.losses, tres.draws) == (jres.wins, jres.losses, jres.draws)
    assert tres.wins + tres.losses + tres.draws == GAMES
    assert tres.half_moves == move
    assert str(tres) == str(jres)


def test_compete_draws_from_a_generator():
    """Without given draws, ``compete`` takes them from its generator: two
    runs from one seed agree, and every game is scored."""
    _, tc, _, tb = _pair(False)
    envs = state_to_torch(jax_opening(jax_engine(3), random_steps=2)(jax.random.PRNGKey(2), GAMES))
    res = [tc(tb[0], tb[1], envs, torch.Generator().manual_seed(7), max_moves=30) for _ in range(2)]
    assert res[0] == res[1]
    assert res[0].wins + res[0].losses + res[0].draws == GAMES


# ---------------------------------------------------------------------------
# Checkpoints, the watchdog and the evaluation driver.
# ---------------------------------------------------------------------------


def test_load_checkpoint_partial(tmp_path, caplog):
    """Keys the file lacks or holds in another shape keep the bundle's
    values, each logged; keys the bundle lacks are ignored; a torn flax
    file raises, and a file of another format ``ForeignCheckpoint``."""
    cfg = NET_PRESETS["tiny3"]
    src = new_agent(cfg, seed=1, device="cpu")
    path = ckpt.save_checkpoint(tmp_path, "a.ckpt", src)
    state = torch.load(path, weights_only=True)
    state["net"]["value.dense.bias"] = torch.zeros(7)  # wrong shape
    del state["net"]["ube.dense.weight"]  # missing
    state["extra"] = torch.zeros(3)  # unknown
    torch.save(state, tmp_path / "b.ckpt")

    dst = new_agent(cfg, seed=2, device="cpu")
    before = {k: v.clone() for k, v in dst["net"].state_dict().items()}
    with caplog.at_level(logging.WARNING):
        out = ckpt.load_checkpoint_partial(tmp_path / "b.ckpt", dst)
    assert out is dst and "folded" not in dst
    want = src["net"].state_dict()
    for k, v in dst["net"].state_dict().items():
        if k in ("value.dense.bias", "ube.dense.weight"):
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, want[k]), k
    assert torch.equal(dst["hash_matrix"], src["hash_matrix"])
    text = caplog.text
    assert "value.dense.bias" in text and "ube.dense.weight" in text and "extra" in text

    # A full file loads everything, as load_checkpoint does.
    full = ckpt.load_checkpoint_partial(path, new_agent(cfg, seed=3, device="cpu"))
    for k, v in full["net"].state_dict().items():
        assert torch.equal(v, want[k]), k
    (tmp_path / "foreign.ckpt").write_bytes(b"\x82\xa6params\x80")  # a msgpack map cut short
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_checkpoint_partial(tmp_path / "foreign.ckpt", dst)
    (tmp_path / "foreign.ckpt").write_bytes(b"\x81\xa4nets\x80")  # a msgpack map, not a JAX bundle
    with pytest.raises(ckpt.ForeignCheckpoint):
        ckpt.load_checkpoint_partial(tmp_path / "foreign.ckpt", dst)


def test_rss_watchdog_exits_42():
    assert watchdog.read_rss_gb() > 0.0
    assert watchdog.start_rss_watchdog(0) is None
    code = ("import time; from takzero_torch.utils import watchdog; "
            "watchdog.start_rss_watchdog(1e-6, interval_s=0.01); time.sleep(30)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=60)
    assert out.returncode == watchdog.RSS_EXIT_CODE == 42


def test_evaluation_driver_pair_on_learner_checkpoints(tmp_path, caplog):
    """``--pair`` on two tiny3 checkpoints the port's learner wrote, through
    ``main(argv)`` on the CPU: two log lines the Elo tooling parses, every
    game scored."""
    d = str(tmp_path)
    learn.main(["--directory", d, "--net", "tiny3", "--seed", "1", "--device", "cpu", "--batch-size", "8",
                "--pretrain-targets", "32", "--pretrain-steps", "2", "--max-steps", "0", "--no-wait"])
    names = sorted(p.name for p in eval_driver.scan_checkpoints(d, 1))
    assert names == ["model_0000000.ckpt", "model_0000002.ckpt"]
    argv = ["--model-path", d, "--net", "tiny3", "--pair", ",".join(names), "--games", "4",
            "--sampled", "4", "--budget", "8", "--max-moves", "12", "--seed", "3", "--rss-limit-gb", "0",
            "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="evaluation"):
        results = eval_driver.main(argv)
    lines = [f"{r.levelname}:{r.name}:{r.getMessage()}" for r in caplog.records if r.name == "evaluation"]
    assert len(lines) == 2 and len(results) == 2
    for line, (a, b, res) in zip(lines, results):
        assert _MATCH.search(line).groups() == (a, b)
        m = PATTERN.search(line)
        assert m and (int(m[5]), int(m[6]), int(m[7])) == (res.wins, res.losses, res.draws)
        assert res.wins + res.losses + res.draws <= 4
        assert line.endswith(f"{res.win_rate() * 100:.1f}%")
    # The same seed plays the same matches; --rounds scans the directory.
    caplog.clear()
    assert [str(r) for *_, r in eval_driver.main(argv)] == [str(r) for *_, r in results]
    rounds = eval_driver.main(argv[:2] + ["--net", "tiny3", "--rounds", "1"] + argv[6:])
    assert len(rounds) == 2 and {rounds[0][0], rounds[0][1]} == set(names)
    with pytest.raises(FileNotFoundError):
        eval_driver.main(argv[:4] + ["--pair", "model_0000000.ckpt,missing.ckpt"] + argv[6:])


# ---------------------------------------------------------------------------
# Puzzles.
# ---------------------------------------------------------------------------


def _puzzle_db(path, rows, size=3):
    """A SQLite database in the reference schema (tests/test_tools.py)."""
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE games (id INTEGER PRIMARY KEY, size INTEGER)")
    con.execute("""CREATE TABLE puzzles (
        game_id INTEGER, tps TEXT, solution TEXT,
        tinue_length INTEGER, tinue_avoidance_length INTEGER,
        tiltak_2komi_second_move_eval REAL, tiltak_2komi_eval REAL)""")
    con.execute("INSERT INTO games VALUES (1, ?)", (size,))
    for tps, sol in rows:
        con.execute("INSERT INTO puzzles VALUES (1, ?, ?, 1, NULL, 0.0, 0.0)", (tps, sol))
    con.commit()
    con.close()


TINUE_3X3 = ("2,x,1/x,1,2/x,1,2 1 4", "b3")  # white completes the b-file road


def test_puzzle_benchmark_on_known_tinue(tmp_path):
    """The 3x3 win-in-1: solved and proven.  k=16 covers every legal root
    move, so the winning move is searched whatever the draws."""
    db = tmp_path / "puzzles.db"
    _puzzle_db(db, [TINUE_3X3])
    for sql, size, depth in ((puzzle.TINUE_SQL, 3, 1), (puzzle.AVOIDANCE_SQL, 3, 2), (puzzle.TINUE_SQL, 6, 3)):
        assert puzzle.fetch_puzzles(db, sql, size, depth) == jax_puzzle.fetch_puzzles(db, sql, size, depth)
    rows = puzzle.fetch_puzzles(db, puzzle.TINUE_SQL, 3, 1)
    assert rows == [TINUE_3X3]

    cfg = NET_PRESETS["tiny3"]
    eng = torch_engine(3)
    from takzero_torch.tak.tps import tps_to_state

    legal = eng.legal_mask(tps_to_state(3, rows[0][0]).map(lambda x: x[None]))
    assert int(legal.sum()) <= 16
    step = puzzle.make_search_step(eng, cfg, make_net_evaluate(cfg, eng, device="cpu"), 16, 64)
    res = puzzle.benchmark(eng, step, new_agent(cfg, seed=0, device="cpu"), rows, True, 3,
                           torch.Generator().manual_seed(0))
    assert (res.attempted, res.solved, res.proven) == (1, 1, 1)
    assert res.nodes > 0 and res.category == "tinue"


def test_puzzle_main_on_learner_checkpoint(tmp_path):
    db = tmp_path / "puzzles.db"
    _puzzle_db(db, [TINUE_3X3, TINUE_3X3])
    agent = new_agent(NET_PRESETS["tiny3"], seed=5, device="cpu")
    path = ckpt.save_checkpoint(tmp_path, "model_0000001.ckpt", agent)
    results = puzzle.main(["--model", str(path), "--puzzle-db", str(db), "--net", "tiny3", "--depths", "1",
                           "--avoidance-depths", "2", "--sampled-actions", "16", "--search-budget", "64",
                           "--device", "cpu"])
    assert [(r.category, r.attempted) for r in results] == [("tinue", 2), ("avoidance", 0)]
    assert results[0].solved == results[0].proven == 2


def test_build_openings_matches_jax(tmp_path):
    """``--opening-book``: the same book lines as JAX's driver picks from
    the same seed, parsed to the same states; without a book, 2-3 random
    plies after the reference opening, the seeded generator drawing the
    same amount from ``rng`` as JAX's key does."""
    from takzero_tpu.drivers.evaluation import build_openings as jax_build

    book = tmp_path / "book.txt"
    book.write_text("x3/x3/x3 1 1\nx3/x,1,x/x3 2 1\n2,x2/x,1,x/x3 1 2\n")
    jstates = jax_build(jax_engine(3), 6, np.random.default_rng(5), str(book))
    tstates = eval_driver.build_openings(torch_engine(3), 6, np.random.default_rng(5), "cpu", str(book))
    assert_state_equal(tstates, jstates, "book openings")

    rng_j, rng_t = np.random.default_rng(6), np.random.default_rng(6)
    jrand = jax_build(jax_engine(4), 8, rng_j)
    trand = eval_driver.build_openings(torch_engine(4), 8, rng_t, "cpu")
    assert trand.ply.tolist() == np.asarray(jrand.ply).tolist()  # the same 2-3 plies
    assert rng_t.integers(1 << 30) == rng_j.integers(1 << 30)


PUZZLE_DB = "examples/puzzles_6x6.db"
DB_COUNTS = {("tinue", 3): 50, ("tinue", 5): 20, ("tinue", 7): 20, ("tinue", 9): 10,
             ("avoidance", 2): 41, ("avoidance", 4): 38, ("avoidance", 6): 59}


def test_fetch_puzzles_matches_jax_on_the_repo_database():
    """Every category and depth of the repository's 6x6 puzzle database."""
    for (category, depth), count in DB_COUNTS.items():
        sql = puzzle.TINUE_SQL if category == "tinue" else puzzle.AVOIDANCE_SQL
        rows = puzzle.fetch_puzzles(PUZZLE_DB, sql, 6, depth)
        assert rows == jax_puzzle.fetch_puzzles(PUZZLE_DB, sql, 6, depth), (category, depth)
        assert len(rows) == count, (category, depth)


def test_puzzle_benchmark_matches_jax_on_a_database_slice(monkeypatch):
    """``benchmark`` with the dummy evaluator on six rows of tinue-3 and six
    of avoidance-2 (k=8, budget 24): the attempted, solved and proven counts
    and the node counts equal JAX's.  The port's root Gumbels are JAX's,
    rebuilt from the key chain of JAX's driver (one split per category, one
    per batch)."""
    from takzero_tpu.search.agents import dummy_evaluator as jax_dummy
    from takzero_tpu.search.gumbel import make_gumbel_search as jax_gumbel_search
    from takzero_tpu.search.tree import init_tree as jax_init_tree
    from takzero_torch.search.agents import dummy_evaluator

    k, budget, children = 8, 24, 256
    jeng, teng = jax_engine(6, half_komi=4), torch_engine(6, half_komi=4)

    def jax_step(envs, bundle, key):  # the JAX driver's search_step
        search = jax_gumbel_search(jeng, jax_dummy(jeng), k, budget, max_depth=48)
        tree = jax_init_tree(jeng, envs, budget + 8, children)
        return search(tree, key, jnp.zeros(envs.ply.shape[0]))[0]

    jstep = jax.jit(jax_step)
    tstep = puzzle.make_search_step(teng, NET_PRESETS["net6_simhash"], lambda b, e: dummy_evaluator(teng)(e),
                                    k, budget)
    key = jax.random.PRNGKey(jax_puzzle.SEED)
    for sql, depth, win in ((puzzle.TINUE_SQL, 3, True), (puzzle.AVOIDANCE_SQL, 2, False)):
        rows = puzzle.fetch_puzzles(PUZZLE_DB, sql, 6, depth)[:6]
        key, kc = jax.random.split(key)
        _, kb = jax.random.split(kc)  # benchmark's split for its one batch
        draws = iter([torch.from_numpy(np.array(jax.random.gumbel(kb, (puzzle.BATCH_SIZE, children))))])
        monkeypatch.setattr(puzzle, "gumbel_noise", lambda gen, shape: next(draws))
        want = jax_puzzle.benchmark(jeng, jstep, None, rows, win, 6, kc)
        got = puzzle.benchmark(teng, tstep, None, rows, win, 6, torch.Generator())
        assert (got.category, got.attempted, got.solved, got.proven, got.nodes, got.nodes_incomplete) == (
            want.category, want.attempted, want.solved, want.proven, want.nodes, want.nodes_incomplete)
        assert got.attempted == 6 and got.nodes > 0
