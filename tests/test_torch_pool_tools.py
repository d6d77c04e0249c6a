"""The pool-size tools of the port (``takzero_torch/tools/{pool,phase,op,
rw}_cliff.py``, ``scatter_variants.py``, ``slope_trace.py``), the
counterparts of JAX's XLA studies, at a tiny size with ``--device cpu``:
each prints one JSON line per measurement with its pool size and device,
the search they time is the port's (the visit counts it leaves), and the
forms of ``scatter_variants`` give ``search/core.py``'s update exactly.
"""

import json

import pytest
import torch

from takzero_torch.search.core import add_path_visits, make_simulate
from takzero_torch.search.tree import init_tree
from takzero_torch.tak.engine import engine
from takzero_torch.tools import cliff_timing, op_cliff, phase_cliff, pool_cliff, rw_cliff, scatter_variants, slope_trace

torch.set_num_threads(2)

SMALL = ["--device", "cpu", "--pools", "12,24", "--batch", "2", "--children", "8"]


def _lines(capsys) -> list[dict]:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("stub", [True, False])
def test_pool_cliff_times_simulate_at_each_pool(capsys, monkeypatch, stub):
    if not stub:  # the flagship net, narrowed so that it runs here
        import takzero_torch.models.network as network

        real = network.NetConfig
        monkeypatch.setattr(network, "NetConfig", lambda **kw: real(**{**kw, "filters": 8, "blocks": 1}))
    rows = pool_cliff.main(SMALL + ["--sims", "3", "--reps", "1"] + (["--stub"] if stub else []))
    printed = _lines(capsys)
    assert [r["M"] for r in rows] == [r["M"] for r in printed] == [12, 24]
    for r in rows:
        assert r["ms_per_sim"] > 0 and r["cpu_ops"] > 0 and r["card"] == "cpu" and r["device"] == "cpu"
        assert r["evaluator"] == ("stub" if stub else "16x256 simhash")


def test_phase_cliff_times_each_phase(capsys):
    rows = phase_cliff.main(SMALL + ["--sims", "2"])
    assert [(r["M"], r["phase"]) for r in rows] == [(m, p) for m in (12, 24) for p in ("forward", "fwd+apply", "full")]
    assert len(_lines(capsys)) == 6
    ops = {(r["M"], r["phase"]): r["cpu_ops"] for r in rows}
    assert ops[(12, "forward")] < ops[(12, "fwd+apply")] < ops[(12, "full")]


def test_op_and_rw_cliff_print_each_primitive(capsys):
    rows = op_cliff.main(SMALL + ["--iters", "2", "--depth", "4"])
    assert len(rows) == 16 and {r["op"] for r in rows} == set(op_cliff.primitives(2, 12, 8, 4, torch.device("cpu")))
    rw = rw_cliff.main(SMALL + ["--iters", "2"])
    assert [(r["M"], r["body"]) for r in rw] == [(m, b) for m in (12, 24) for b in ("scatter", "gather", "gather+sc")]
    printed = _lines(capsys)
    assert len(printed) == 16 + 6 + 1 and printed[-1]["pools"] == [12, 24]
    assert all(r["us_per_iter"] > 0 for r in rows + rw)


def test_scatter_variants_agree_exactly(capsys):
    rows = scatter_variants.main(SMALL + ["--iters", "2", "--depth", "6"])
    assert len(rows) == 10 and all(r["equal_to_core"] for r in rows)
    # The check itself: each form against the core form, at other shapes.
    for b, m, c, d in ((3, 40, 16, 12), (1, 9, 5, 8)):
        scatter_variants.check_variants(b, m, c, d, torch.device("cpu"))
    node, slot = scatter_variants.paths(2, 20, 8, 6, torch.device("cpu"))
    a = torch.zeros((2, 20, 8), dtype=torch.int32)
    add_path_visits(a, node, slot)
    for lane in range(2):
        live = node[lane] >= 0
        assert a[lane].sum() == live.sum() and a[lane, node[lane][live].long(), slot[lane][live].long()].eq(1).all()
    assert len(_lines(capsys)) == 10


def test_slope_trace_diffs_the_two_pools(tmp_path, capsys):
    res = slope_trace.main(SMALL + ["--sims", "2", "--out", str(tmp_path)])
    assert res["pools"] == [12, 24] and set(res["per_sim"]) == {12, 24}
    # The pool's arrays are read by row: each op over [B, M + 1, ...] runs
    # as often at either size.
    assert res["ops_over_the_pool"] and all(r["count_hi"] == r["count_lo"] for r in res["ops_over_the_pool"])
    assert (tmp_path / "report.txt").read_text().startswith("pools 12 vs 24")
    assert len(_lines(capsys)) == 3


def test_tools_time_the_ports_simulation():
    """The loop the tools time is the drivers' search: after ``sims``
    simulations of the stub evaluator every root holds ``sims`` visits."""
    eng = engine(6, half_komi=4)
    dev = torch.device("cpu")
    envs = cliff_timing.openings(eng, 2, 0, dev)
    tree = init_tree(eng, envs, 12, 8)
    simulate = make_simulate(eng, cliff_timing.stub_evaluator(eng), max_depth=48)
    for _ in range(5):
        simulate(tree, torch.full((2,), 0.25))
    assert tree.root_visit.tolist() == [5, 5]
