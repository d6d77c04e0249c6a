"""Helpers shared by the parity tests of ``takzero_torch`` against
``takzero_tpu``: moving states and trees between the two packages as numpy
arrays, comparing them, and rebuilding the JAX program's random draws.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from takzero_tpu.tak.state import TakState as JaxState
from takzero_torch.tak.state import TakState, join_owner, split_owner


def state_to_torch(js) -> TakState:
    """JAX TakState (any leading dims) -> the port's TakState on the CPU."""
    a = {k: np.asarray(v) for k, v in js._asdict().items()}
    i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))  # noqa: E731
    return TakState(
        height=i32(a["height"]),
        owner=join_owner(
            torch.from_numpy(a["owner_lo"].astype(np.int64)),
            torch.from_numpy(a["owner_hi"].astype(np.int64)),
        ),
        tops=i32(a["tops"]),
        reserves=i32(a["reserves"]),
        to_move=i32(a["to_move"]),
        ply=i32(a["ply"]),
        reversible=i32(a["reversible"]),
    )


def state_to_jax(ts: TakState) -> JaxState:
    lo, hi = split_owner(ts.owner)
    u32 = lambda x: x.numpy().astype(np.uint32)  # noqa: E731
    return JaxState(
        height=ts.height.numpy(),
        owner_lo=u32(lo),
        owner_hi=u32(hi),
        tops=ts.tops.numpy(),
        reserves=ts.reserves.numpy(),
        to_move=ts.to_move.numpy(),
        ply=ts.ply.numpy(),
        reversible=ts.reversible.numpy(),
    )


def assert_state_equal(ts: TakState, js, where: str = "") -> None:
    """Exact equality of every field, the owner lanes through split_owner."""
    got = state_to_jax(ts)
    for name in JaxState._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(js, name)),
            err_msg=f"{where}: TakState.{name}",
        )


def assert_tree_equal(tt, jt, where: str = "", tol: dict | None = None) -> None:
    """Every Tree array equal to JAX's, except the scratch row (the last pool
    row, a write sink whose content is garbage by design).

    Every array must match exactly, except the float arrays named in ``tol``
    (name -> relative and absolute tolerance), which callers give with a
    reason.
    """
    tol = tol or {}
    scratch = jt.child_visit.shape[1] - 1
    for name, jv in jt._asdict().items():
        if name == "node_env":
            tv = state_to_jax(tt.node_env)
            for f in JaxState._fields:
                a = np.asarray(getattr(tv, f))[:, :scratch]
                b = np.asarray(getattr(jv, f))[:, :scratch]
                np.testing.assert_array_equal(a, b, err_msg=f"{where}: node_env.{f}")
            continue
        a = getattr(tt, name).numpy()
        b = np.asarray(jv)
        if a.ndim >= 2 and a.shape[1] == scratch + 1 and name not in ("free_rows",):
            a, b = a[:, :scratch], b[:, :scratch]
        if name in tol:
            np.testing.assert_allclose(a, b, rtol=tol[name], atol=tol[name], err_msg=f"{where}: {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def tree_to_torch(jt):
    """A JAX Tree -> the port's Tree on the CPU (every array copied)."""
    from takzero_torch.search.tree import Tree

    fields = {}
    for name, v in jt._asdict().items():
        if name == "node_env":
            fields[name] = state_to_torch(v)
        else:
            fields[name] = torch.from_numpy(np.array(v))
    return Tree(**fields)


def _as_t(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def opening_draws(key, batch: int) -> dict:
    """The draws of JAX's ``new_opening(key, batch)``: a symmetry and a
    corner pair per game."""
    k_sym, k_pair, _ = jax.random.split(key, 3)
    return dict(
        open_sym=_as_t(jax.random.randint(k_sym, (batch,), 0, 8), torch.int64),
        open_pair=_as_t(jax.random.randint(k_pair, (batch,), 0, 2), torch.int64),
    )


def move_draws(key, batch: int, children: int) -> dict:
    """The draws of one JAX selfplay move, rebuilt from its key.

    ``SelfplayEngine._move`` splits its key into (search, sample, opening);
    ``jax.random.categorical(k, logits)`` equals
    ``argmax(logits + gumbel(k, logits.shape))``, so the selfplay sample is
    one Gumbel draw over the root slots.
    """
    k_search, k_sample, k_open = jax.random.split(key, 3)
    return dict(
        gumbel_root=_as_t(jax.random.gumbel(k_search, (batch, children)), torch.float32),
        gumbel_sample=_as_t(jax.random.gumbel(k_sample, (batch, children)), torch.float32),
        **opening_draws(k_open, batch),
    )


def search_draws(key, batch: int, children: int) -> torch.Tensor:
    """The root Gumbel draw of a JAX search given ``key`` itself.

    JAX's ``make_reanalyze_step`` passes its key straight to the search,
    which draws ``jax.random.gumbel(key, (B, C))``; do not use
    :func:`move_draws` for it, whose split gives other Gumbels.
    """
    return _as_t(jax.random.gumbel(key, (batch, children)), torch.float32)


def tall_states(n, batch, seed):
    """Random positions with stacks of up to 56 pieces (colour bits above 32).

    56 + a carry of n <= 8 stays within the 64-bit field."""
    rng = np.random.default_rng(seed)
    s = n * n
    height = np.zeros((batch, s), np.int32)
    tops = np.zeros((batch, s), np.int32)
    lo = np.zeros((batch, s), np.uint32)
    hi = np.zeros((batch, s), np.uint32)
    for b in range(batch):
        for sq in rng.choice(s, size=s // 2, replace=False):
            h = int(rng.integers(1, 57)) if rng.random() < 0.5 else int(rng.integers(33, 57))
            bits = rng.integers(0, 2, size=h)
            v = int(sum(int(x) << i for i, x in enumerate(bits)))
            height[b, sq] = h
            lo[b, sq] = v & 0xFFFFFFFF
            hi[b, sq] = v >> 32
            tops[b, sq] = int(rng.choice([1, 1, 2, 3]))
    return JaxState(
        height=height,
        owner_lo=lo,
        owner_hi=hi,
        tops=tops,
        reserves=np.full((batch, 2, 2), 5, np.int32),
        to_move=rng.integers(0, 2, size=batch).astype(np.int32),
        ply=np.full((batch,), 10, np.int32),
        reversible=np.zeros((batch,), np.int32),
    )
