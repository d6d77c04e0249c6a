"""host_syncs_per_sim.selfplay: blocking reads of the device per batched
simulation.

Source: the host slice of the traced move.  Every read of a device value
by the host (``aten::item``, ``aten::is_nonzero`` through
``aten::_local_scalar_dense``, ``.cpu()``) is one device-to-host copy
that the host waits for, so the count is the number of such copies: the
count of ``profile_move.py`` (``aten::item`` and ``aten::is_nonzero``),
without counting one read twice, and with the copies of whole tensors."""

from benchmark.harness.trace import is_dtoh

SOURCE = "device_trace"
SLICE = "host"


def read(trace):
    sl = trace.slices.get(SLICE)
    if sl is None or not sl.device:
        return None
    return sum(1 for name, _, _ in sl.device if is_dtoh(name)) / sl.units
