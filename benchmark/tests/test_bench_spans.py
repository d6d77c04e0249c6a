"""The span readers (``harness/spans.py`` and the ``program_span``
metrics that read the program's ``search.*``, ``sync`` and ``tei.*``
spans) on hand-built traces."""

import pytest

from benchmark.harness import spans, spec
from benchmark.harness.trace import SliceData, Trace

MAIN, OTHER = 1, 2

# (name, start_us, dur_us, thread) in a 1,000 us slice of 2 units.
HOST = [
    ("search.forward", 0.0, 100.0, MAIN),
    ("aten::index", 5.0, 3.0, MAIN),
    ("sync", 10.0, 20.0, MAIN),
    ("aten::_local_scalar_dense", 12.0, 17.0, MAIN),
    ("sync", 50.0, 10.0, MAIN),
    ("search.evaluate", 100.0, 80.0, MAIN),
    ("search.apply_eval", 180.0, 20.0, MAIN),
    ("search.forward", 200.0, 100.0, MAIN),
    ("sync", 250.0, 30.0, MAIN),
    ("search.backward", 300.0, 50.0, MAIN),
    ("sync", 320.0, 5.0, MAIN),
    ("tei.position", 400.0, 60.0, MAIN),
    ("sync", 410.0, 6.0, MAIN),
    ("aten::add", 500.0, 1.0, MAIN),
    # Another thread's events are not the program's.
    ("search.forward", 0.0, 1000.0, OTHER),
    ("sync", 600.0, 100.0, OTHER),
]
WINDOW = {"units": 10, "seconds": 2.0}  # 200 ms a unit unprofiled

# Self microseconds of each metric's span in HOST.
SELF_US = {
    "forward_host_ms.selfplay": (100 - 20 - 10) + (100 - 30),
    "evaluator_host_ms.selfplay": 80,
    "apply_eval_host_ms.selfplay": 20,
    "backward_host_ms.selfplay": 50 - 5,
    "sync_wait_ms.selfplay": 20 + 10 + 30 + 5 + 6,
    "position_host_ms.serve": 60 - 6,
}


def _trace(host=HOST, window=WINDOW, slices=("host",)) -> Trace:
    sl = {name: SliceData(name, 2, 1e-3, [], host) for name in slices}
    return Trace(cell="selfplay.net6_simhash", cfg={}, traffic={}, slices=sl, window=dict(window))


def test_main_thread_is_the_busiest():
    assert spans.main_thread(HOST) == MAIN
    assert spans.main_thread([]) is None


def test_self_time_less_the_syncs_inside():
    assert spans.self_us(HOST, "search.forward") == 140.0
    assert spans.self_us(HOST, "sync") == 71.0  # a sync holds no other
    assert spans.self_us(HOST, "search.evaluate") == 80.0
    assert spans.self_us(HOST, "no.such.span") is None


def test_scaled_by_the_window_per_unit():
    # 140 us of a 1,000 us slice is 14% of the host's time; 14% of the
    # window's 200 ms a unit is 28 ms.
    assert spans.host_ms_per_unit(_trace(), "search.forward") == pytest.approx(28.0)
    half = _trace(window={"units": 20, "seconds": 2.0})
    assert spans.host_ms_per_unit(half, "search.forward") == pytest.approx(14.0)


@pytest.mark.parametrize("metric", sorted(SELF_US))
def test_each_reader_reads_its_span(metric):
    reader = spec.reader(metric)
    assert reader.SOURCE == "program_span"
    assert reader.read(_trace()) == pytest.approx(SELF_US[metric] / 1000 * 200.0)


@pytest.mark.parametrize("metric", sorted(SELF_US))
def test_each_reader_finds_nothing_without_its_slice_or_span(metric):
    reader = spec.reader(metric)
    assert reader.read(_trace(slices=("device",))) is None  # no host slice
    assert reader.read(_trace(host=[("aten::add", 0.0, 1.0, MAIN)])) is None  # the parent: no spans
    assert reader.read(_trace(window={"units": 0, "seconds": 2.0})) is None
