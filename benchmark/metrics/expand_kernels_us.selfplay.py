"""expand_kernels_us.selfplay: device microseconds per batched simulation
in the search's two expansion kernels (``takzero_torch/ops/tree.py``,
``csrc/expand.cu``): every game's legal mask and kernel A's input before
kernel A, its statistics, priors and guarded stores after it.

Source: the device slice of the traced move, the summed device time of
the kernels' launches over the simulations of the slice.  A program that
expands the leaves with batched operators instead has no such kernels,
and the reader then reads nothing."""

from benchmark.harness.trace import matching

SOURCE = "device_trace"
SLICE = "device"
PATTERNS = (r"\bexpand_mask_kernel\b", r"\bexpand_store_kernel\b")


def read(trace):
    sl = trace.slices.get(SLICE)
    if sl is None or not sl.units:
        return None
    ev = matching(sl.device, PATTERNS)
    if not ev:
        return None
    return sum(d for _, _, d in ev) / sl.units
