"""idle_share.selfplay: the share of the window in which the device ran
nothing.

Source: the device busy time per batched simulation in the device slice
(the union of its events), over the wall time per batched simulation of
the unprofiled window of the same run; never over a wall time measured
under the profiler, which inflates it."""

from benchmark.harness.trace import busy_us

SOURCE = "device_trace"
SLICE = "device"


def read(trace):
    sl = trace.slices.get(SLICE)
    units, seconds = trace.window.get("units"), trace.window.get("seconds")
    if sl is None or not sl.device or not units:
        return None
    busy = busy_us(sl.device) / 1e6 / sl.units
    return 100.0 * (1.0 - busy / (seconds / units))
