"""settle_kernel_us.selfplay: device microseconds per batched simulation
in the search's settle kernel (``takzero_torch/ops/tree.py``,
``csrc/settle.cu``): every game's depth clip, path visits, leaf step and
terminal discovery.

Source: the device slice of the traced move, the summed device time of
the kernel's launches over the simulations of the slice.  A program that
settles the leaves with batched operators instead has no such kernel, and
the reader then reads nothing."""

from benchmark.harness.trace import matching

SOURCE = "device_trace"
SLICE = "device"
PATTERNS = (r"\btree_settle_kernel\b",)


def read(trace):
    sl = trace.slices.get(SLICE)
    if sl is None or not sl.units:
        return None
    ev = matching(sl.device, PATTERNS)
    if not ev:
        return None
    return sum(d for _, _, d in ev) / sl.units
