"""launches_per_sim.selfplay: device kernels, copies and sets per batched
simulation (one ``simulate`` call over every game of the batch).

Source: the device slice of the traced move (``harness/trace.py``),
every event the profiler records on the device, over the simulations of
the slice."""

SOURCE = "device_trace"
SLICE = "device"


def read(trace):
    sl = trace.slices.get(SLICE)
    if sl is None or not sl.device:
        return None
    return len(sl.device) / sl.units
