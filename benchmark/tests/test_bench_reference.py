"""The plain reference against the program on the CPU at small sizes: the
two are written apart, so agreement here is evidence for both."""

import random

import numpy as np
import pytest
import torch

from benchmark.reference import net, search, tak

from takzero_torch.models.agent import simhash_indices
from takzero_torch.models.network import NetConfig, RndPair, TakNet, apply_folded, fold_inference_params
from takzero_torch.ops.repr import state_to_planes
from takzero_torch.search.gumbel import sh_schedule
from takzero_torch.tak.engine import engine
from takzero_torch.tak.moves import action_to_ptn
from takzero_torch.tak.state import TakState


def program_state(ps):
    def col(f, dtype):
        return torch.tensor(np.array([f(p) for p in ps]), dtype=dtype)

    return TakState(
        col(lambda p: [len(s) for s in p.stacks], torch.int32),
        col(lambda p: [sum(c << i for i, c in enumerate(s)) for s in p.stacks], torch.int64),
        col(lambda p: p.tops, torch.int32), col(lambda p: p.reserves, torch.int32),
        col(lambda p: p.to_move, torch.int32), col(lambda p: p.ply, torch.int32),
        col(lambda p: p.reversible, torch.int32))


def playouts(n, games, seed):
    rng, out = random.Random(seed), []
    for _ in range(games):
        p = tak.initial(n)
        for _ in range(rng.randrange(0, 50)):
            if tak.game_over(p):
                break
            p = tak.step(p, rng.choice(tak.legal_actions(p)))
        out.append(p)
    return out


@pytest.mark.parametrize("n", [5, 6])
def test_rules_and_planes_match_the_program(n):
    ps = playouts(n, 48, n)
    eng = engine(n, half_komi=4)
    st = program_state(ps)
    mask = eng.legal_mask(st)
    rng = random.Random(1)
    for i, p in enumerate(ps):
        legal = tak.legal_actions(p)
        assert legal == torch.nonzero(mask[i]).flatten().tolist()
        a = rng.choice(legal)
        after = eng.step(st.map(lambda x: x[i : i + 1]), torch.tensor([a]))
        assert tak.from_fields(n, *(x[0].numpy() for x in after)).key() == tak.step(p, a).key()
        assert tak.from_tps(n, tak.to_tps(p)).key()[:-1] == p.key()[:-1]
    assert torch.equal(state_to_planes(eng, st), net.planes(ps, 4))
    roads = eng._roads(st)
    assert [[tak.has_road(p, 0), tak.has_road(p, 1)] for p in ps] == roads.tolist()


@pytest.mark.parametrize("n", [5, 6])
def test_moves_match_the_program(n):
    a = net.num_actions(n)
    assert all(tak.ptn(n, x) == action_to_ptn(n, x) and tak.parse_ptn(n, tak.ptn(n, x)) == x
               for x in range(a))


def test_network_simhash_and_rnd_match_the_program():
    cfg = {"n": 6, "half_komi": 4, "filters": 16, "blocks": 2, "residual_gain": 0.25, "policy_gain": 4.0,
           "head_gain": 0.004}
    weights = net.make_params(net.net_spec(cfg), torch.Generator().manual_seed(3), "cpu")
    model = TakNet(NetConfig(n=6, half_komi=4, filters=16, blocks=2))
    model.load_state_dict(weights)
    ps = playouts(6, 32, 7)
    x = net.planes(ps, 4)
    got = apply_folded(model.cfg, fold_inference_params(model.cfg, model), x)
    want = net.tower_and_heads(weights, x, 2)
    rms = float(want[0].pow(2).mean().sqrt())
    assert float((got[0] - want[0]).abs().max()) < 0.1 * rms  # bf16 against float32
    assert float((got[1] - want[1]).abs().max()) < 0.05
    matrix = torch.randn(x[0].numel(), 32, generator=torch.Generator().manual_seed(4))
    assert torch.equal(simhash_indices(model.cfg, matrix, x), net.simhash_indices(x, matrix))
    rcfg = NetConfig(n=5, filters=16, blocks=1, novelty="rnd", rnd_mlp=True)
    rw = net.make_params(net.rnd_spec({"n": 5}), torch.Generator().manual_seed(5), "cpu")
    pair = RndPair(rcfg)
    pair.load_state_dict(rw)
    x5 = net.planes(playouts(5, 16, 8), 4)
    torch.testing.assert_close(pair(x5), net.rnd_error(rw, x5), rtol=0.05, atol=1e-3)


def test_visitations_match_the_schedule():
    for k, budget in ((64, 384), (64, 768), (4, 96), (2, 2)):
        assert search.improved_policy_visitations(k, budget) == float(sh_schedule(k, budget)[3][-1])
