"""The port's visualizers and plots (``drivers/{graph,visualize_replay_buffer,
visualize_search}.py``, ``tools/{logs,plots}.py``) against the JAX
package's, on the CPU.

* ``graph``: the uniqueness curves equal JAX's, and its HTML and CSV files
  are byte for byte JAX's.
* ``visualize_replay_buffer``: the three opening books are byte for byte
  JAX's for the same ``--seed``.
* ``visualize_search`` at tiny3 from a ``--tps`` position: the search tree
  after each beta's visits equals JAX's (every integer array exactly, the
  float arrays within 1e-5: the evaluator's float32 sums differ in order),
  the host arrays it draws are JAX's, and its SVG from the same host arrays
  is byte for byte JAX's; ``main`` writes one SVG per beta.
* ``moving_average`` equals JAX's; the plots write their PNGs, and without
  matplotlib ``--png`` raises an ``ImportError`` that names the flag while
  the HTML and CSV outputs are written all the same.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import takzero_tpu.drivers.graph as jax_graph
import takzero_tpu.drivers.visualize_replay_buffer as jax_vrb
import takzero_tpu.drivers.visualize_search as jax_vs
import takzero_torch.drivers.graph as torch_graph
import takzero_torch.drivers.visualize_replay_buffer as torch_vrb
import takzero_torch.drivers.visualize_search as torch_vs
from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.data.target import Replay as JaxReplay
from takzero_tpu.models import agent as jax_agent
from takzero_tpu.search import core as jax_core
from takzero_tpu.search import tree as jax_tree
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import state_to_tps as jax_state_to_tps
from takzero_tpu.tak import tps_to_state as jax_tps_to_state
from takzero_tpu.tak.oracle import Oracle
from takzero_tpu.tools import logs as jax_logs
from takzero_tpu.train import data as jax_data
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS
from takzero_torch.models.agent import make_net_evaluate
from takzero_torch.search.core import make_simulate
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tak.tps import tps_to_state
from takzero_torch.tools import logs as torch_logs
from takzero_torch.tools import plots as torch_plots

from torch_parity import assert_tree_equal

torch.set_num_threads(2)


def _write_replays(path, games: int, seed: int, n: int = 3) -> None:
    """Random-playout replays through JAX's C++ oracle (as tests/test_tools2.py)."""
    eng = jax_engine(n)
    orc = Oracle(n, 0, eng.reversible_limit)
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(games):
        start = jax_data._host_opening(eng, orc, rng)
        _, actions, res = orc.random_playout(start, seed=int(rng.integers(1, 2**31)), max_plies=40)
        if res >= 0:
            lines.append(JaxReplay(tps=jax_state_to_tps(n, start), actions=[int(a) for a in actions], n=n).to_line())
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def replay_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("replays")
    _write_replays(d / "a_replays.txt", 12, seed=1)
    _write_replays(d / "b_replays.txt", 12, seed=2)
    return d / "a_replays.txt", d / "b_replays.txt"


def test_graph_matches_jax(replay_files, tmp_path):
    a, b = replay_files
    for rate in (10, 37):
        want = jax_graph.unique_position_curve(3, a, positions_cap=200, point_rate=rate)
        assert torch_graph.unique_position_curve(3, a, positions_cap=200, point_rate=rate, device="cpu") == want
    outputs = {}
    for name, main, extra in (("jax", jax_graph.main, []), ("torch", torch_graph.main, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        main([str(a), str(b), "--n", "3", "--positions", "150", "--point-rate", "20",
              "--out", str(out / "graph.html"), "--csv", str(out / "graph.csv")] + extra)
        outputs[name] = [(out / f).read_bytes() for f in ("graph.html", "graph.csv")]
    assert outputs["torch"] == outputs["jax"]
    assert b"polyline" in outputs["torch"][0]


def test_opening_books_match_jax(replay_files, tmp_path, monkeypatch):
    a, b = replay_files
    books = {}
    for name, main, extra in (("jax", jax_vrb.main, []), ("torch", torch_vrb.main, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.chdir(out)
        main([str(a), str(b), "--n", "3", "--initial", "120", "--sample", "15", "--seed", "4"] + extra)
        books[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert list(books["torch"]) == ["positions_both.opening_book", "positions_only_a.opening_book",
                                    "positions_only_b.opening_book"]
    assert books["torch"] == books["jax"]


@pytest.fixture
def exact_topk_on_jax(monkeypatch):
    # JAX's search off the TPU uses lax.top_k unless told to select as the
    # kernel does (tests/test_torch_search.py).
    monkeypatch.setenv("TAKZERO_TOPK", "exact_ref")


def _jax_host(tree, n: int) -> dict:
    """The host arrays of JAX's ``visualize_search.main``."""
    host = {k: np.asarray(getattr(tree, k)[0]) for k in ("child_action", "child_visit", "child_node", "root_visit")}
    live = np.asarray(tree.node_live[0])
    host["node_tps"] = [
        jax_state_to_tps(n, jax.tree.map(lambda x: np.asarray(x[0, i]), tree.node_env)) if live[i] else ""
        for i in range(tree.child_action.shape[1])
    ]
    return host


def test_visualize_search_matches_jax(exact_topk_on_jax, tmp_path):
    n, visits, children = 3, 14, 32
    tps = "x,2,x/x,1,x/x3 1 2"
    jcfg, tcfg = JAX_PRESETS["tiny3"], NET_PRESETS["tiny3"]
    jeng, teng = jax_engine(n, half_komi=jcfg.half_komi), torch_engine(n, half_komi=tcfg.half_komi)
    jbundle = jax_agent.new_agent(jcfg, seed=0)
    tbundle = from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")
    jev = jax_agent.make_net_evaluate(jcfg, jeng)
    jsim = jax.jit(lambda tree, beta: jax_core.make_simulate(jeng, lambda envs: jev(jbundle, envs), max_depth=64)(
        tree, beta))
    tev = make_net_evaluate(tcfg, teng, device="cpu")
    tsim = make_simulate(teng, lambda envs: tev(tbundle, envs), max_depth=64)
    jenvs = jax.tree.map(lambda x: jnp.asarray(x)[None], jax_tps_to_state(n, tps))
    tenvs = tps_to_state(n, tps).map(lambda x: x[None])
    tol = {k: 1e-5 for k in ("child_logit", "child_prob", "child_value", "child_std", "root_value", "root_std")}
    for beta in (0.0, 1.0):
        jt = jax_tree.init_tree(jeng, jenvs, visits + 8, children)
        for _ in range(visits):
            jt = jsim(jt, jnp.full((1,), beta))
        tt = torch_vs.search_tree(teng, tsim, tenvs, beta, visits, children)
        assert_tree_equal(tt, jt, f"beta {beta}", tol)
        host = torch_vs.host_arrays(tt, n)
        want = _jax_host(jt, n)
        assert host["node_tps"] == want["node_tps"] and int(host["root_visit"]) == visits
        for k in ("child_action", "child_visit", "child_node", "root_visit"):
            np.testing.assert_array_equal(host[k], want[k], err_msg=k)
        (tmp_path / "jax").mkdir(exist_ok=True)
        (tmp_path / "torch").mkdir(exist_ok=True)
        svg_jax = jax_vs.visualize(host, n, beta, tmp_path / "jax").read_bytes()
        svg = torch_vs.visualize(host, n, beta, tmp_path / "torch").read_bytes()
        assert svg == svg_jax and svg.count(b"<circle") > 1
    assert torch_vs.opacity(50) == jax_vs.opacity(50) == 1.0 and torch_vs.opacity(5) == jax_vs.opacity(5)


def test_visualize_search_main_writes_each_beta(tmp_path):
    out = torch_vs.main(["--net", "tiny3", "--visits", "12", "--betas", "0,1", "--out-dir", str(tmp_path),
                         "--max-children", "32", "--device", "cpu"])
    assert [p.name for p, _ in out] == ["tree_with_beta=0.0.svg", "tree_with_beta=1.0.svg"]
    assert [int(host["root_visit"]) for _, host in out] == [12, 12]
    svg = out[0][0].read_text()
    assert "<circle" in svg and 'tps="' in svg and svg.endswith("]]></script></svg>")


def test_moving_average_matches_jax():
    x = np.random.default_rng(0).normal(size=300)
    for n in (1, 7, 128, 400):
        np.testing.assert_array_equal(torch_logs.moving_average(x, n), jax_logs.moving_average(x, n))


def test_plots_and_missing_matplotlib(replay_files, tmp_path, monkeypatch):
    csv = tmp_path / "eee.csv"
    csv.write_text("step,current,after\n" + "".join(f"{i},{4 - i / 50},{i / 60}\n" for i in range(40)))
    torch_plots.plot_eee(csv, tmp_path / "eee.png", window=5)
    torch_plots.plot_seen_ratio([(0, 0.1), (1, 0.5), (2, 0.9)], tmp_path / "seen.png")
    torch_plots.plot_uniqueness({"a": [(0.0, 1.0), (10.0, 0.5)]}, tmp_path / "u.png")
    assert all((tmp_path / f).stat().st_size > 0 for f in ("eee.png", "seen.png", "u.png"))

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--png"):
        torch_plots.plot_seen_ratio([(0, 1.0)], tmp_path / "none.png")
    a, _ = replay_files
    with pytest.raises(ImportError, match="--png"):
        torch_graph.main([str(a), "--n", "3", "--point-rate", "20", "--out", str(tmp_path / "g.html"),
                          "--csv", str(tmp_path / "g.csv"), "--png", str(tmp_path / "g.png"), "--device", "cpu"])
    assert (tmp_path / "g.html").exists() and (tmp_path / "g.csv").exists() and not (tmp_path / "g.png").exists()
