"""idle_share.serve: the share of the window in which the device ran
nothing.

Source: the device busy time per ``go`` in the device slice (the union
of its events) over the wall time per ``go`` of the unprofiled window of
the same run."""

from benchmark.harness.trace import busy_us

SOURCE = "device_trace"
SLICE = "device"


def read(trace):
    sl = trace.slices.get(SLICE)
    units, seconds = trace.window.get("units"), trace.window.get("seconds")
    if sl is None or not sl.device or not units:
        return None
    return 100.0 * (1.0 - busy_us(sl.device) / 1e6 / sl.units / (seconds / units))
