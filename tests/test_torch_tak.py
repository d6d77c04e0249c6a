"""The port's rules engine (takzero_torch.tak) against the JAX engine.

Random playouts at 3x3 to 6x6: after every ply, ``legal_mask``, ``step``,
``_roads``, ``game_result``, ``terminal_kind``, ``top_color`` and
``flat_diff`` must equal the JAX engine's exactly.  Stacks taller than 32
exercise the int64 colour field against JAX's two uint32 lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from takzero_tpu.tak import engine as jax_engine
from takzero_tpu.tak.state import TakState as JaxState
from takzero_tpu.tak.state import initial_state_batch as jax_initial_batch
from takzero_torch.tak import engine as torch_engine
from takzero_torch.tak.state import join_owner, split_owner

from torch_parity import assert_state_equal, state_to_torch, tall_states

torch.set_num_threads(2)


def _jax_fns(eng):
    v = lambda f: jax.jit(jax.vmap(f))  # noqa: E731
    return dict(
        legal=v(eng.legal_mask),
        step=v(eng.step),
        roads=v(eng._roads),
        result=v(eng.game_result),
        kind=v(eng.terminal_kind),
        top=v(eng.top_color),
        diff=v(eng.flat_diff),
    )


def _compare(jf, teng, js, ts, where):
    assert_state_equal(ts, js, where)
    for name, tfn in (
        ("legal", teng.legal_mask),
        ("roads", teng._roads),
        ("result", teng.game_result),
        ("kind", teng.terminal_kind),
        ("top", teng.top_color),
        ("diff", teng.flat_diff),
    ):
        np.testing.assert_array_equal(
            tfn(ts).numpy(), np.asarray(jf[name](js)), err_msg=f"{where}: {name}"
        )


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_random_playouts_match_jax(n):
    batch, plies = 24, 60 if n < 6 else 100
    jeng, teng = jax_engine(n, half_komi=2 * (n % 2)), torch_engine(n, half_komi=2 * (n % 2))
    jf = _jax_fns(jeng)
    rng = np.random.default_rng(100 + n)
    js = jax_initial_batch(n, batch)
    ts = teng.initial(batch)
    terminals = 0
    for ply in range(plies):
        _compare(jf, teng, js, ts, f"n={n} ply={ply}")
        legal = np.asarray(jf["legal"](js))
        # Flat placements 60% of the time (roads form), else any legal
        # move (mostly spreads once the board fills, so stacks grow).
        flats = legal[:, : n * n]
        use_flat = (rng.random(batch) < 0.6) & flats.any(1)
        actions = np.zeros(batch, np.int32)
        for i in range(batch):
            choices = np.flatnonzero(flats[i] if use_flat[i] else legal[i])
            actions[i] = rng.choice(choices) if len(choices) else 0
        js = jf["step"](js, jnp.asarray(actions))
        ts = teng.step(ts, torch.from_numpy(actions))
        # Restart finished games (and lanes with no legal move) in both.
        done = (np.asarray(jf["kind"](js)) != 0) | ~np.asarray(jf["legal"](js)).any(1)
        terminals += int(done.sum())
        if done.any():
            fresh = jax_initial_batch(n, batch)
            js = JaxState(*(
                jnp.where(done.reshape((-1,) + (1,) * (a.ndim - 1)), f, a)
                for f, a in zip(fresh, js)
            ))
            tfresh = teng.initial(batch)
            mask = torch.from_numpy(done)
            ts = type(ts)(*(
                torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), f, a)
                for f, a in zip(tfresh, ts)
            ))
    _compare(jf, teng, js, ts, f"n={n} end")
    assert terminals > 0, "playouts never reached a terminal"


def test_owner_round_trip_above_32():
    js = tall_states(6, 8, seed=0)
    ts = state_to_torch(js)
    assert int(ts.height.max()) > 32
    lo, hi = split_owner(ts.owner)
    np.testing.assert_array_equal(lo.numpy().astype(np.uint32), js.owner_lo)
    np.testing.assert_array_equal(hi.numpy().astype(np.uint32), js.owner_hi)
    np.testing.assert_array_equal(join_owner(lo, hi).numpy(), ts.owner.numpy())
    # Bit 63 set: the int64 is negative, and the split still masks it back.
    full = torch.tensor([-1, -(2**62), 2**62], dtype=torch.int64)
    flo, fhi = split_owner(full)
    assert flo.tolist() == [0xFFFFFFFF, 0, 0]
    assert fhi.tolist() == [0xFFFFFFFF, 0xC0000000, 0x40000000]
    np.testing.assert_array_equal(join_owner(flo, fhi).numpy(), full.numpy())


@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_tall_stack_spreads_match_jax(n):
    jeng, teng = jax_engine(n), torch_engine(n)
    jf = _jax_fns(jeng)
    js = tall_states(n, 16, seed=n)
    ts = state_to_torch(js)
    _compare(jf, teng, js, ts, "tall")
    legal = np.asarray(jf["legal"](js))
    rng = np.random.default_rng(7)
    for rep in range(6):
        acts = np.zeros(16, np.int32)
        for i in range(16):
            spread = np.flatnonzero(legal[i, 3 * n * n:]) + 3 * n * n
            acts[i] = rng.choice(spread) if len(spread) else np.flatnonzero(legal[i])[0]
        js2 = jf["step"](js, jnp.asarray(acts))
        ts2 = teng.step(ts, torch.from_numpy(acts))
        _compare(jf, teng, js2, ts2, f"tall step {rep}")
