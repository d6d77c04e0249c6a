"""The port's reuse A/B (``takzero_torch/tools/reuse_ab.py``) against
JAX's ``tools/reuse_ab.py`` at tiny3 on the CPU.

JAX's main runs on a JAX checkpoint with its net in float32; the port's two
directions run from JAX's openings and JAX's Gumbel draws (the
``jax.random.split`` chain of ``evaluation.py:138``, as
``tests/test_torch_evaluation.py`` replays it) on the bridged weights in
float32.  JAX's search runs under ``TAKZERO_TOPK=exact_ref`` (kernel A's
contract).  W/L/D must be equal in each direction and in all.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.config import NET_PRESETS as JAX_PRESETS
from takzero_tpu.models.agent import new_agent as jax_new_agent
from takzero_tpu.search.openings import make_new_opening as jax_opening
from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tools import reuse_ab as jax_reuse_ab
from takzero_tpu.utils import ckpt as jax_ckpt
from takzero_torch.bridge import from_jax_bundle
from takzero_torch.config import NET_PRESETS, selfplay_preset
from takzero_torch.models.agent import make_net_evaluate, new_agent
from takzero_torch.tak import engine
from takzero_torch.tools import reuse_ab
from takzero_torch.utils import ckpt

from torch_parity import state_to_torch

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def exact_topk_on_jax():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("TAKZERO_TOPK", "exact_ref")
        yield


GAMES, BUDGET, SAMPLED, MAX_MOVES = 4, 16, 4, 30


def test_reuse_ab_directions_match_jax(tmp_path, monkeypatch, capsys, caplog):
    """JAX's reuse_ab main (its net in float32) on a JAX checkpoint, and the
    port's two directions from JAX's openings and JAX's Gumbel draws on the
    bridged weights: the same W/L/D in each direction and in all."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny3"], compute_dtype=jnp.float32)
    monkeypatch.setitem(JAX_PRESETS, "tiny3", jcfg)
    jb = jax_new_agent(jcfg, seed=3)
    jax_ckpt.save_checkpoint(tmp_path, "model.ckpt", jb)
    caplog.set_level(logging.INFO, logger="reuse_ab")
    jax_reuse_ab.main(["--ckpt", str(tmp_path / "model.ckpt"), "--net", "tiny3", "--games", str(GAMES),
                       "--budget", str(BUDGET), "--sampled", str(SAMPLED), "--max-moves", str(MAX_MOVES),
                       "--seed", "2"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want_lines = [r.getMessage() for r in caplog.records if r.name == "reuse_ab"]
    caplog.clear()

    tcfg = dataclasses.replace(NET_PRESETS["tiny3"], compute_dtype=torch.float32)
    tb = from_jax_bundle(jax.tree.map(np.asarray, jb), tcfg, device="cpu")
    sp = selfplay_preset("tiny3", search_budget=BUDGET, sampled_actions=SAMPLED)
    envs = state_to_torch(jax_opening(jax_engine(3), random_steps=2)(jax.random.PRNGKey(2), GAMES))
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(2 * MAX_MOVES):
        key, k = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.gumbel(k, (GAMES, sp.max_children)))))
    per = reuse_ab.play_directions(engine(3), make_net_evaluate(tcfg, engine(3), device="cpu"), sp, tb,
                                   (envs, envs), (draws, draws), MAX_MOVES)
    assert [r.getMessage() for r in caplog.records if r.name == "reuse_ab"] == want_lines
    got = [sum(r[k] for r in per) for k in ("wins", "losses", "draws")]
    assert got == [want["reuse_wins"], want["reuse_losses"], want["draws"]]
    assert sum(got) == want["games"] == 2 * GAMES


def test_reuse_ab_main_on_the_cpu(tmp_path, capsys):
    ckpt.save_checkpoint(tmp_path, "model.ckpt", new_agent(NET_PRESETS["tiny3"], seed=1, device="cpu"))
    out = tmp_path / "summary.json"
    summary = reuse_ab.main(["--ckpt", str(tmp_path / "model.ckpt"), "--net", "tiny3", "--games", str(GAMES),
                             "--budget", str(BUDGET), "--sampled", str(SAMPLED), "--max-moves", str(MAX_MOVES),
                             "--device", "cpu", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary == json.loads(out.read_text())
    assert summary["games"] == 2 * GAMES == summary["reuse_wins"] + summary["reuse_losses"] + summary["draws"]
    jax_keys = {"net", "games", "budget", "sampled", "max_children", "reuse_wins", "reuse_losses", "draws",
                "reuse_score", "wall_s"}
    assert set(summary) == jax_keys | {"half_moves"} and summary["half_moves"] > 0
