"""The benchmark's arithmetic against hand counts and known samples."""

import pytest

from benchmark.harness import counts, stats, trace


def test_evaluator_flops_by_hand():
    # 6x6, 16x256: 36 planes in, 251 policy channels out, 36 squares.
    s = 36
    conv = lambda cin, cout: 2 * 9 * cin * cout * s  # noqa: E731
    want = conv(36, 256) + 32 * conv(256, 256) + conv(256, 251) + 2 * (2 * 256 * s + 2 * s)
    cfg = {"n": 6, "filters": 256, "blocks": 16, "novelty": "simhash"}
    assert counts.evaluator_flops(cfg) == want
    assert 1.40e9 < want < 1.42e9


def test_rnd_mlp_flops_by_hand():
    base = {"n": 5, "filters": 256, "blocks": 20, "novelty": "rnd"}
    mlp = 2 * 2 * (800 * 1024 + 1024 * 1024 + 1024 * 512)  # predictor and target
    assert counts.evaluator_flops({**base, "rnd_mlp": True}) - counts.evaluator_flops(base) == mlp


def test_kernel_bytes_by_hand():
    assert counts.topk_bytes(128, 9036, 256) == 128 * 9036 * 4 + 128 * 256 * 8 == 4_888_576
    assert counts.simhash_bytes(128, 1296, 32) == 128 * 1296 * 4 + 1296 * 32 * 4 + 128 * 8
    # 10 launches of 4.89 MB in 100 us reach 4.89e7 / 3.35e12 / 1e-4 of the bound.
    share = counts.roofline_share(10, 4_888_576, 1e-4)
    assert share == pytest.approx(100 * 10 * 4_888_576 / 3.35e12 / 1e-4)
    assert counts.roofline_share(0, 1, 1.0) is None


def test_whole_move_rate():
    # Three whole moves of 128 games at budget 384 in 30 s.
    sims = stats.selfplay_sims(384, 128, 3)
    assert sims == 385 * 128 * 3
    assert stats.rate(sims, 30.0) == pytest.approx(4928.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p90_on_known_samples():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile([5.0, 1.0, 3.0], 90) == 5.0
    assert stats.percentile([2.0], 90) == 2.0


def test_busy_union_and_idle_gaps():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 10.0), ("k3", 30.0, 5.0)]
    assert trace.busy_us(device) == 20.0
    host = [("outer", 0.0, 100.0, 1), ("aten::item", 14.0, 20.0, 1), ("other", 0.0, 1.0, 2)]
    assert trace.idle_gaps(device, host) == [["aten::item", 15e-6]]
    assert trace.top_device_ops(device, 2) == [["k1", 10e-6], ["k2", 10e-6]]
