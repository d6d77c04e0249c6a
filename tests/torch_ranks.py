"""Rank bodies for the tests of the port's process groups.

``takzero_torch.parallel.multihost.run_ranks`` runs each of these in every
spawned rank of a gloo group on the CPU (``tests/test_torch_parallel.py``,
``tests/test_torch_multihost.py``).  They import no JAX: a rank needs only
the port.
"""

import pickle

import numpy as np
import torch

from takzero_torch.bridge import from_jax_bundle
from takzero_torch.models.agent import hash_update, make_net_evaluate, new_agent
from takzero_torch.parallel import multihost
from takzero_torch.tak.engine import engine
from takzero_torch.tak.state import TakState
from takzero_torch.train.learner import Batch, make_optimizer, make_train_step


def _host(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def parallel_cases(path: str) -> dict:
    """The cases pickled at ``path``, on this rank's rows: one train step
    per ``train`` case from its bridged JAX bundle, ``hash_update`` per
    ``hash`` case, the collectives, and a fresh agent's weights."""
    with open(path, "rb") as f:
        cases = pickle.load(f)
    world = multihost.global_world("cpu")
    out = {"rank": world.rank, "size": world.size, "train": [], "hash": []}
    for case in cases["train"]:
        cfg = case["cfg"]
        bundle = from_jax_bundle(case["bundle"], cfg, device="cpu")
        batch = Batch(*(torch.from_numpy(np.array(x)) for x in case["batch"]))
        m = make_train_step(cfg, world)(bundle, make_optimizer(bundle), world.rows(batch), case["train_ube"])
        out["train"].append({
            "metrics": {k: float(v) for k, v in m.items()},
            "net": _host(bundle["net"].state_dict()),
            "rnd": _host(bundle["rnd"].state_dict()) if "rnd" in bundle else None,
            "hash_bits": bundle["hash_bits"].numpy().copy() if "hash_bits" in bundle else None,
        })
    for case in cases["hash"]:
        bundle = from_jax_bundle(case["bundle"], case["cfg"], device="cpu")
        planes = torch.from_numpy(np.array(case["planes"]))
        hash_update(case["cfg"], bundle, world.rows(planes), world)
        out["hash"].append(bundle["hash_bits"].numpy().copy())
    agent = new_agent(cases["fresh_cfg"], seed=3, device="cpu")
    out["fresh"] = _host(agent["net"].state_dict())
    # The padded evaluator on this rank's rows, its outputs gathered.
    cfg = cases["evaluate"]["cfg"]
    envs = TakState(*(torch.from_numpy(x) for x in cases["evaluate"]["envs"]))
    evaluate = make_net_evaluate(cfg, engine(cfg.n, half_komi=cfg.half_komi), device="cpu", world=world)
    outs = evaluate(new_agent(cfg, seed=cases["evaluate"]["seed"], device="cpu"), envs.map(world.rows))
    out["evaluate"] = [world.gather(x).numpy() for x in outs]
    # The collectives, each with rank-dependent inputs.
    r = world.rank
    out["scalar"] = multihost.broadcast_scalar(1000 + r)
    out["lines"] = multihost.broadcast_lines([f"line {i} of rank {r}" for i in range(3)] if r == 0 else None)
    out["no_lines"] = multihost.broadcast_lines([] if r == 0 else ["ignored"])
    out["gather"] = world.gather(torch.arange(3) + 10 * r).tolist()
    out["gather_dim1"] = world.gather(torch.full((2, 1), r), dim=1).tolist()
    out["gather_bool"] = world.gather(torch.tensor([r == 0, True])).tolist()
    grads = [torch.full((2, 2), float(r + 1)), torch.arange(3.0) * (r + 1)]
    multihost.all_reduce_flat(grads)
    out["flat"] = [g.tolist() for g in grads]
    out["mean"] = float(multihost.all_reduce_mean(torch.tensor(float(r))))
    out["batch_slice"] = multihost.process_batch_slice(64)
    return out


def learn_counting_broadcasts(argv: list) -> dict:
    """``drivers.learn.main(argv)`` with the broadcasts counted: how many
    of each, and the number of lines each ``broadcast_lines`` carried."""
    from takzero_torch.drivers import learn

    calls = {"scalar": 0, "lines": 0, "payloads": []}
    scalar, lines = multihost.broadcast_scalar, multihost.broadcast_lines

    def count_scalar(v):
        calls["scalar"] += 1
        return scalar(v)

    def count_lines(x):
        calls["lines"] += 1
        out = lines(x)
        calls["payloads"].append(len(out))
        return out

    multihost.broadcast_scalar, multihost.broadcast_lines = count_scalar, count_lines
    try:
        learn.main(argv)
    finally:
        multihost.broadcast_scalar, multihost.broadcast_lines = scalar, lines
    return calls
