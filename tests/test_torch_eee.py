"""The port's EEE experiments (takzero_torch.eee, drivers/eee.py) against the
JAX package's, on the CPU at 3x3 with tiny nets.

* ``impossible_permutation``, ``replay_positions`` (order, plies, TPS and
  states) and ``reference_batches`` with JAX's draws, through the
  replay-pool branch and the random fallback: bit for bit (JAX's jitted
  plane encoder is one float32 ulp off in the reserve planes, a JAX-side
  quirk listed in ROADMAP.md queue 3: those planes are held exactly
  against JAX's eager encoder and within one ulp of the jitted one).
* ``make_new_opening`` with per-ply draws (a callable) and
  ``random_plane_batch``'s planes: bit for bit against the tensor form and
  against JAX.
* ``train.data.make_batch``: bit for bit, the augmented states included.
* ``make_hash_step`` under SimHash and the LCG hash over 3 steps: every
  metric exact, the seen-sets bit for bit after each step.
* ``seen_ratio.run`` at batch 16 with JAX's draws: exact.
* ``make_rnd_step`` (conv tower and MLP) from bridged weights in float32:
  metrics within 1e-4 relative over 2 steps.
* ``make_ensemble_step`` from bridged weights: in float32 the metrics, the
  weights and the BatchNorm statistics within 1e-4 relative after one
  step; in bf16 the losses within 2e-3 (PR 3's tolerance for a bf16 train
  step), the variances and the policy logits after the step within 5e-2,
  and the policy argmax equal wherever the top two logits are not tied
  within that rounding.
* Each ``run`` writes the reference CSV header and one row per step;
  ``drivers.eee`` parses JAX's flags into the same calls, refuses
  ``--devices``, and ``seen-ratio --model`` refuses a JAX checkpoint of
  another width than its preset's.

JAX runs its step functions jitted as its ``run`` loops do; its ``run``
loops themselves are not run (their own tests are marked slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from takzero_tpu.data.target import Replay as JaxReplay
from takzero_tpu.eee import ensemble as jax_ensemble
from takzero_tpu.eee import generalization as jax_generalization
from takzero_tpu.eee import harness as jax_harness
from takzero_tpu.eee import rnd as jax_rnd
from takzero_tpu.eee import seen_ratio as jax_seen_ratio
from takzero_tpu.models import agent as jax_agent
from takzero_tpu.models import network as jax_network
from takzero_tpu.ops import repr as jax_repr
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak import state_to_tps as jax_state_to_tps
from takzero_tpu.tak.oracle import Oracle
from takzero_tpu.train import data as jax_data
from takzero_torch.bridge import from_jax_bundle, rnd_pair_from_jax
from takzero_torch.data.target import Target
from takzero_torch.eee import ensemble as torch_ensemble
from takzero_torch.eee import generalization as torch_generalization
from takzero_torch.eee import harness as torch_harness
from takzero_torch.eee import rnd as torch_rnd
from takzero_torch.eee import seen_ratio as torch_seen_ratio
from takzero_torch.models import network as torch_network
from takzero_torch.ops.repr import stack_size
from takzero_torch.search.openings import make_new_opening
from takzero_torch.tak import engine as torch_engine
from takzero_torch.train import data as torch_data

from torch_parity import assert_state_equal, random_game_draws

torch.set_num_threads(2)

N = 3
CPU = torch.device("cpu")
TINY = dict(n=N, half_komi=0, filters=8, blocks=1)


def _write_replays(path, games: int, seed: int) -> None:
    """Random-playout replays through JAX's C++ oracle (as tests/test_eee.py)."""
    eng = jax_engine(N)
    orc = Oracle(N, 0, eng.reversible_limit)
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(games):
        start = jax_data._host_opening(eng, orc, rng)
        _, actions, res = orc.random_playout(start, seed=int(rng.integers(1, 2**31)), max_plies=60)
        if res >= 0:
            lines.append(JaxReplay(tps=jax_state_to_tps(N, start), actions=[int(a) for a in actions], n=N).to_line())
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    path = tmp_path_factory.mktemp("eee") / "replays.txt"
    _write_replays(path, 24, seed=5)
    return path


def _assert_planes_match(got: torch.Tensor, want, what: str, n: int = N) -> None:
    """Exact, but for one ulp of JAX's jitted encoder in the reserve planes."""
    got, want = got.numpy(), np.asarray(want)
    reserve = 2 * stack_size(n) + np.arange(4)
    other = np.setdiff1d(np.arange(got.shape[1]), reserve)
    np.testing.assert_array_equal(got[:, other], want[:, other], err_msg=what)
    np.testing.assert_array_max_ulp(got[:, reserve], want[:, reserve], maxulp=1)


def _eager_planes(jeng, jstates) -> np.ndarray:
    return np.asarray(jax.vmap(lambda s: jax_repr.state_to_planes(jeng, s))(jax.tree.map(jnp.asarray, jstates)))


def _random_planes(batch: int, ply: int, seed: int) -> torch.Tensor:
    return torch_harness.random_plane_batch(torch_engine(N), torch.Generator().manual_seed(seed), ply, batch)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_impossible_permutation_matches_jax(n):
    got = torch_harness.impossible_permutation(n)
    want = jax_harness.impossible_permutation(n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_per_ply_draws_match_tensor_form_and_jax():
    """One ply's draws at a time give the plies of the tensor form and of
    JAX's opening at 4x4, planes included (``test_reference_batches_match_jax``
    holds ``random_plane_batch``'s per-ply draws against JAX's at 3x3)."""
    n, ply, batch = 4, 3, 16
    jeng, teng = jax_engine(n), torch_engine(n)
    key = jax.random.PRNGKey(10 + n)
    d = random_game_draws(key, ply, batch, teng.num_actions)
    handed = []

    def per_ply(i):
        handed.append(i)
        return d["gumbel"][i]

    opening = make_new_opening(teng, random_steps=ply)
    tensor_form = opening(d["sym"], d["pair"], d["gumbel"])
    got = opening(d["sym"], d["pair"], per_ply)
    assert handed == list(range(ply))
    for a, b in zip(got, tensor_form):
        assert torch.equal(a, b)
    jstates = jax_harness.make_new_opening(jeng, random_steps=ply)(key, batch)
    assert_state_equal(got, jstates, f"{n}x{n} opening, {ply} plies one at a time")
    planes = torch_harness.random_planes(teng, ply, d["sym"], d["pair"], per_ply)
    np.testing.assert_array_equal(planes.numpy(), _eager_planes(jeng, jstates))
    gen = torch.Generator().manual_seed(0)
    assert torch_harness.random_plane_batch(teng, gen, ply, batch).shape == planes.shape


def test_replay_positions_match_jax(replays):
    jeng, teng = jax_engine(N), torch_engine(N)
    want = list(jax_harness.replay_positions(jeng, replays))
    states, plies, tps = torch_harness.replay_positions(teng, replays, CPU)
    assert tps == [t for _, _, t in want]
    assert plies.tolist() == [p for _, p, _ in want]
    stacked = jax_data.stack_states([s for s, _, _ in want])
    assert_state_equal(states, stacked, "replay positions")
    limit = len(want) // 3
    states, plies, tps = torch_harness.replay_positions(teng, replays, CPU, limit=limit)
    assert tps == [t for _, _, t in want[:limit]] and len(plies) == limit


def test_reference_batches_match_jax(replays):
    """early from the replay pool (ply 2), late falling back to random games
    (ply 30), and the three random batches, from JAX's key."""
    jeng, teng = jax_engine(N), torch_engine(N)
    batch, early, late = 8, 2, 30
    unique_jax, seen = {}, set()
    for state, ply, tps in jax_harness.replay_positions(jeng, replays):
        if tps not in seen:
            seen.add(tps)
            unique_jax.setdefault(ply, []).append(state)
    _, unique = torch_harness.load_replay_positions(teng, replays, CPU)
    assert {p: len(v) for p, v in unique_jax.items()} == {p: int(v.ply.shape[0]) for p, v in unique.items()}
    assert len(unique_jax[early]) >= batch > len(unique_jax.get(late, []))

    key = jax.random.PRNGKey(4)
    want = jax_harness.reference_batches(jeng, unique_jax, key, batch, early_ply=early, late_ply=late)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    a = teng.num_actions
    draws = {"seed": np.asarray(jax.random.key_data(k5)).ravel()[-1]}
    for name, k, ply in (("early", k1, early), ("late", k2, late), ("random_early", k3, early),
                         ("random_late", k4, late), ("impossible_early", k6, early)):
        d = random_game_draws(k, ply, batch, a)
        draws[name] = {**d, "gumbel": lambda i, g=d["gumbel"]: g[i]}  # one ply at a time
    sources = {}
    got = torch_harness.reference_batches(teng, unique, draws, batch, early_ply=early, late_ply=late,
                                          sources=sources)
    assert [sources[k]["from"] for k in ("early", "late")] == ["replay pool", "random games"]
    assert list(got) == list(want)
    for name in want:
        _assert_planes_match(got[name], want[name], name)


def test_make_batch_matches_jax():
    jeng, teng = jax_engine(4, half_komi=4), torch_engine(4, half_komi=4)
    jtargets = jax_data.random_pretraining_targets(jeng, 24, np.random.default_rng(8))
    ttargets = [Target.from_line(4, t.to_line()) for t in jtargets]
    for augment in (True, False):
        want, jstates = jax_data.make_batch(jeng, jtargets, np.random.default_rng(5), augment=augment,
                                            return_states=True)
        got, tstates = torch_data.make_batch(teng, ttargets, np.random.default_rng(5), augment=augment,
                                             return_states=True, device="cpu")
        assert_state_equal(tstates, jstates, f"make_batch states, augment={augment}")
        for name, g, w in zip(("policy", "mask", "value", "ube"), got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(got.planes.numpy(), _eager_planes(jeng, jstates))
        _assert_planes_match(got.planes, want.planes, "make_batch planes", 4)


# ---------------------------------------------------------------------------
# The step functions
# ---------------------------------------------------------------------------


def _refs(batch: int, seed: int) -> dict:
    return {name: _random_planes(batch, ply, seed + i)
            for i, (name, ply) in enumerate(zip(torch_rnd.REF_NAMES, (2, 5, 1, 6, 3)))}


@pytest.mark.parametrize("novelty", ["simhash", "lcghash"])
def test_hash_step_matches_jax(novelty):
    jcfg = jax_network.NetConfig(**TINY, novelty=novelty, hash_bits=12)
    tcfg = torch_network.NetConfig(**TINY, novelty=novelty, hash_bits=12)
    jbundle = jax_agent.new_agent(jcfg, seed=3)
    jbundle = {k: v for k, v in jbundle.items() if not k.startswith(("params", "batch"))}
    bridged = from_jax_bundle(jax.tree.map(np.asarray, jax_agent.new_agent(jcfg, seed=3)), tcfg, device="cpu")
    state = {k: v for k, v in bridged.items() if k.startswith("hash")}
    refs = _refs(8, seed=20)
    jrefs = {k: jnp.asarray(v.numpy()) for k, v in refs.items()}
    jstep, tstep = jax_generalization.make_hash_step(jcfg), torch_generalization.make_hash_step(tcfg)
    for i in range(3):
        planes = torch.cat([_random_planes(4, 1, seed=30), _random_planes(4, 2 + i, seed=31 + i)])
        jbundle, jm = jstep(jbundle, jnp.asarray(planes.numpy()), jrefs)
        state, tm = tstep(state, planes, refs)
        assert torch_rnd.to_floats(tm) == {k: float(v) for k, v in jm.items()}, f"step {i}"
        words = np.asarray(jbundle["hash_bits"], np.uint32).view(np.int32)
        np.testing.assert_array_equal(state["hash_bits"].numpy(), words, err_msg=f"seen-set after step {i}")
    assert torch_rnd.to_floats(tm)["current"] < 4.0  # step 2 met positions of earlier steps


def test_seen_ratio_matches_jax():
    jcfg = jax_network.NetConfig(**TINY, novelty="simhash", hash_bits=12)
    tcfg = torch_network.NetConfig(**TINY, novelty="simhash", hash_bits=12)
    jbundle = jax_agent.new_agent(jcfg, seed=1)
    marked = torch.cat([_random_planes(16, ply, seed=40 + ply) for ply in range(3)])
    jbundle = jax_agent.hash_update(jcfg, jbundle, jnp.asarray(marked.numpy()))
    tbundle = from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")
    want = jax_seen_ratio.run(jbundle, jcfg, max_ply=3, batch=16, seed=7)
    a = torch_engine(N).num_actions
    got = torch_seen_ratio.run(
        tbundle, tcfg, max_ply=3, batch=16, seed=7, device="cpu",
        draws=lambda ply: random_game_draws(jax.random.fold_in(jax.random.PRNGKey(7), ply), ply, 16, a),
    )
    assert got == want
    assert 0.0 < min(r for _, r in got) < 1.0


@pytest.mark.parametrize("mlp", [False, True], ids=["tower", "mlp"])
def test_rnd_step_matches_jax(mlp):
    kw = dict(**TINY, novelty="rnd", rnd_filters=8, rnd_blocks=1, rnd_mlp=mlp)
    jcfg = jax_network.NetConfig(**kw, compute_dtype=jnp.float32)
    tcfg = torch_network.NetConfig(**kw, compute_dtype=torch.float32)
    model = jax_network.RndPair(jcfg)
    variables = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 24, N, N), jnp.float32), train=False)
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    tx = optax.adam(1e-4)
    opt_state = tx.init(variables["params"])
    rnd = rnd_pair_from_jax(jax.tree.map(np.asarray, variables["params"]),
                            jax.tree.map(np.asarray, variables["batch_stats"]), tcfg, device="cpu")
    opt = torch_rnd.make_rnd_optimizer(rnd)
    jstep, tstep = jax_rnd.make_rnd_step(jcfg, tx), torch_rnd.make_rnd_step(tcfg)
    refs = _refs(8, seed=50)
    jrefs = {k: jnp.asarray(v.numpy()) for k, v in refs.items()}
    for i in range(2):
        planes = _random_planes(16, 2 + i, seed=60 + i)
        variables, opt_state, jm = jstep(variables, opt_state, jnp.asarray(planes.numpy()), jrefs)
        tm = torch_rnd.to_floats(tstep(rnd, opt, planes, refs))
        assert set(tm) == set(jm)
        for k, v in jm.items():
            assert tm[k] == pytest.approx(float(v), rel=1e-4), f"step {i} {k}"
        assert tm["after"] < tm["current"]


def _ensemble_case(dtype: str):
    jcfg = jax_network.NetConfig(**TINY, novelty="ensemble", ensemble_size=4, compute_dtype=getattr(jnp, dtype))
    tcfg = torch_network.NetConfig(**TINY, novelty="ensemble", ensemble_size=4, compute_dtype=getattr(torch, dtype))
    jeng, teng = jax_engine(N), torch_engine(N)
    jbundle = jax_agent.new_agent(jcfg, seed=3)
    tbundle = from_jax_bundle(jax.tree.map(np.asarray, jbundle), tcfg, device="cpu")
    jtargets = jax_data.random_pretraining_targets(jeng, 16, np.random.default_rng(4))
    ttargets = [Target.from_line(N, t.to_line()) for t in jtargets]
    jbatch, jstates = jax_data.make_batch(jeng, jtargets, np.random.default_rng(5), return_states=True)
    tbatch, tstates = torch_data.make_batch(teng, ttargets, np.random.default_rng(5), return_states=True,
                                            device="cpu")
    key = jax.random.PRNGKey(9)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (16, teng.num_actions))))
    refs = _refs(8, seed=70)
    tx = optax.adam(1e-4)
    opt_state = tx.init((jbundle["params"], jbundle["ensemble_params"]))
    # JAX's step reads its batch planes from the jitted encoder; hand both
    # sides the same (exact) planes.
    jbatch = jbatch._replace(planes=jnp.asarray(tbatch.planes.numpy()))
    jnew, _, jm = jax_ensemble.make_ensemble_step(jcfg, jeng, tx)(
        jbundle, opt_state, jbatch, jstates, key, {k: jnp.asarray(v.numpy()) for k, v in refs.items()})
    opt = torch_ensemble.make_ensemble_optimizer(tbundle)
    tm = torch_ensemble.to_floats(torch_ensemble.make_ensemble_step(tcfg, teng)(
        tbundle, opt, tbatch, tstates, gumbel, refs))
    assert set(tm) == set(jm)
    return jcfg, jnew, {k: float(v) for k, v in jm.items()}, tcfg, tbundle, tm, tbatch


def test_ensemble_step_matches_jax_float32():
    _, jnew, jm, tcfg, tbundle, tm, _ = _ensemble_case("float32")
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    want = from_jax_bundle(jax.tree.map(np.asarray, jnew), tcfg, device="cpu")
    for key in ("net", "ensemble"):
        got_sd, want_sd = tbundle[key].state_dict(), want[key].state_dict()
        for name, w in want_sd.items():
            torch.testing.assert_close(got_sd[name], w, rtol=1e-4, atol=1e-7, msg=lambda m: f"{key}.{name}: {m}")


def test_ensemble_step_matches_jax_bfloat16():
    jcfg, jnew, jm, _, tbundle, tm, tbatch = _ensemble_case("bfloat16")
    for k, v in jm.items():
        tol = 2e-3 if k.startswith("loss") else 5e-2
        assert abs(tm[k] - v) <= tol * max(1.0, abs(v)), (k, tm[k], v)
    jpolicy = jax_network.TakNet(jcfg).apply(
        {"params": jnew["params"], "batch_stats": jnew["batch_stats"]}, jnp.asarray(tbatch.planes.numpy()))[0]
    with torch.no_grad(), torch_network.conv_precision(torch.bfloat16):
        tpolicy = tbundle["net"](tbatch.planes)[0]
    jpolicy, tpolicy = np.asarray(jpolicy), tpolicy.numpy()
    np.testing.assert_allclose(tpolicy, jpolicy, rtol=5e-2, atol=5e-2)
    # The argmax is equal on every row but those whose top two logits are
    # tied in JAX within one bf16 step (found: one row of 16, exactly tied
    # in JAX, one bf16 step apart here).
    top2 = np.sort(jpolicy, axis=-1)[:, -2:]
    ulp = torch.finfo(torch.bfloat16).eps * np.exp2(np.floor(np.log2(np.maximum(np.abs(top2[:, 1]), 1e-30))))
    clear = top2[:, 1] - top2[:, 0] > ulp
    np.testing.assert_array_equal(tpolicy.argmax(-1)[clear], jpolicy.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# The runs and the driver
# ---------------------------------------------------------------------------


def _csv_rows(path):
    lines = path.read_text().splitlines()
    assert lines[0] == jax_rnd.CSV_HEADER == torch_rnd.CSV_HEADER
    return [line.split(",") for line in lines[1:]]


@pytest.mark.parametrize("experiment", ["rnd", "simhash", "lcghash", "ensemble"])
def test_run_writes_reference_csv(experiment, replays, tmp_path):
    out = tmp_path / "eee.csv"
    report = {}
    if experiment == "rnd":
        rows = torch_rnd.run(replays, out, n=N, half_komi=0, steps=3, batch_size=8, seed=7, device="cpu",
                             report=report)
        assert rows[-1]["after"] <= rows[-1]["current"]
    elif experiment == "ensemble":
        targets = jax_data.random_pretraining_targets(jax_engine(N), 48, np.random.default_rng(3))
        (tmp_path / "targets.txt").write_text("\n".join(t.to_line() for t in targets) + "\n")
        rows = torch_ensemble.run(tmp_path / "targets.txt", out, n=N, half_komi=0, steps=2, batch_size=8,
                                  filters=8, blocks=1, ensemble_size=4, seed=11, take=24, device="cpu")
        assert all(np.isfinite(m["loss"]) and m["loss_ensemble"] >= 0 for m in rows)
    else:
        rows = torch_generalization.run(replays, out, n=N, half_komi=0, novelty=experiment, hash_bits=12,
                                        steps=3, batch_size=8, seed=7, device="cpu", report=report)
        assert rows[0]["current"] == 4.0 and all(m["after"] == 0.0 for m in rows)
        assert all(0.0 <= v <= 4.0 for m in rows for v in m.values())
    assert len(rows) == (2 if experiment == "ensemble" else 3)
    csv = _csv_rows(out)
    assert [int(r[0]) for r in csv] == list(range(len(rows)))
    assert [float(x) for x in csv[-1][1:]] == [rows[-1][k] for k in torch_rnd.CSV_HEADER.split(",")[1:]]
    if report:
        assert set(report["sources"]) == {"early", "late"}


_FLAGS = {
    "rnd": ["rnd", "--replays", "r.txt", "--out", "o.csv", "--n", "5", "--half-komi", "2", "--steps", "7",
            "--batch-size", "16", "--seed", "3", "--rnd-mlp"],
    "generalization": ["generalization", "--replays", "r.txt", "--novelty", "lcghash", "--hash-bits", "20",
                       "--steps", "9", "--batch-size", "32", "--seed", "4", "--n", "3"],
    "ensemble": ["ensemble", "--targets", "t.txt", "--steps", "5", "--batch-size", "64", "--filters", "32",
                 "--blocks", "2", "--ensemble-size", "8", "--seed", "5", "--half-komi", "0"],
    "seen-ratio": ["seen-ratio", "--model", "m.ckpt", "--net", "tiny3", "--max-ply", "12", "--batch", "256",
                   "--seed", "9"],
}


@pytest.mark.parametrize("cmd", list(_FLAGS) + ["defaults"])
def test_driver_parses_jax_flags(cmd, monkeypatch):
    """The same argv reaches the same ``run`` call in both packages (the
    port adds ``device``); the defaults are JAX's."""
    import takzero_tpu.drivers.eee as jax_driver
    import takzero_tpu.eee.seen_ratio as jsr
    import takzero_tpu.models.agent as jagent
    import takzero_tpu.utils.ckpt as jckpt
    import takzero_torch.drivers.eee as torch_driver
    import takzero_torch.eee.seen_ratio as tsr
    import takzero_torch.models.agent as tagent
    import takzero_torch.utils.ckpt as tckpt

    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return []

    for mod in (jax_rnd, jax_generalization, jax_ensemble, jsr, torch_rnd, torch_generalization, torch_ensemble,
                tsr):
        monkeypatch.setattr(mod, "run", record)
    for agent, ck in ((jagent, jckpt), (tagent, tckpt)):
        monkeypatch.setattr(agent, "new_agent", lambda cfg, seed=0, device=None: {"seed": seed})
        monkeypatch.setattr(ck, "load_checkpoint", lambda path, bundle: {"path": path, **bundle})
    argvs = [["rnd", "--replays", "r.txt"], ["generalization", "--replays", "r.txt"], ["ensemble", "--targets", "t"],
             ["seen-ratio", "--model", "m"]] if cmd == "defaults" else [_FLAGS[cmd]]
    for argv in argvs:
        jax_driver.main(argv)
        torch_driver.main(argv + ["--device", "cpu"])
        (jargs, jkw), (targs, tkw) = calls[-2:]
        if argv[0] == "seen-ratio":
            assert tkw.pop("device") == torch.device("cpu")
        else:
            assert tkw.pop("device") == "cpu"
        assert tkw == jkw, argv
        if argv[0] == "seen-ratio":  # the config: the port's preset of the same name
            assert targs[0] == jargs[0] and targs[1] == torch_driver_config(argv)
        else:
            assert targs == jargs, argv


def torch_driver_config(argv):
    from takzero_torch.config import NET_PRESETS

    net = argv[argv.index("--net") + 1] if "--net" in argv else "net6_simhash"
    return NET_PRESETS[net]


def test_driver_refuses_devices_and_foreign_checkpoints(tmp_path, monkeypatch):
    from takzero_tpu.utils import ckpt as jax_ckpt
    from takzero_torch.drivers import eee as torch_driver
    from takzero_torch.models.agent import new_agent
    from takzero_torch.utils import ckpt

    with pytest.raises(NotImplementedError, match="--devices"):
        torch_driver.main(["rnd", "--replays", "r.txt", "--device", "cpu", "--devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="--devices"):
        torch_driver.main(["seen-ratio", "--model", "m", "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    jcfg = jax_network.NetConfig(**TINY, novelty="simhash", hash_bits=12)
    foreign = jax_ckpt.save_checkpoint(str(tmp_path), "model_jax.ckpt", jax_agent.new_agent(jcfg))
    # A JAX run's file is read (tests/test_torch_flax_ckpt.py); one of
    # another width than the preset's does not fit.
    with pytest.raises(ckpt.CheckpointMismatch):
        torch_driver.main(["seen-ratio", "--model", str(foreign), "--net", "tiny3", "--device", "cpu"])
    # The port's own checkpoint: the ratios, their CSV and figure.
    path = ckpt.save_checkpoint(tmp_path, "model_0000000.ckpt", new_agent(torch_driver_config(["--net", "tiny3"]),
                                                                           seed=1, device="cpu"))
    pairs = torch_driver.main(["seen-ratio", "--model", str(path), "--net", "tiny3", "--device", "cpu",
                               "--max-ply", "3", "--batch", "16", "--csv", str(tmp_path / "s.csv"),
                               "--png", str(tmp_path / "s.png")])
    assert pairs == [(0, 1.0), (1, 1.0), (2, 1.0)]  # an empty seen-set
    assert (tmp_path / "s.csv").read_text() == "ply,unseen_ratio\n0,1.0\n1,1.0\n2,1.0\n"
    assert (tmp_path / "s.png").stat().st_size > 0
