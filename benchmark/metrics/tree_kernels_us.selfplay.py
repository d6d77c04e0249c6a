"""tree_kernels_us.selfplay: device microseconds per batched simulation
in the search's descent and backup kernels (``takzero_torch/ops/tree.py``,
``csrc/tree.cu``): every game's walk from its root to a leaf and back.

Source: the device slice of the traced move, the summed device time of
the two kernels' launches over the simulations of the slice.  A program
that walks the trees with batched operators instead has no such kernel,
and the reader then reads nothing."""

from benchmark.harness.trace import matching

SOURCE = "device_trace"
SLICE = "device"
PATTERNS = (r"\btree_descend_kernel\b", r"\btree_backup_kernel\b")


def read(trace):
    sl = trace.slices.get(SLICE)
    if sl is None or not sl.units:
        return None
    ev = matching(sl.device, PATTERNS)
    if not ev:
        return None
    return sum(d for _, _, d in ev) / sl.units
