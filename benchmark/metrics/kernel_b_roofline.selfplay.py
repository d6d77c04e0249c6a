"""kernel_b_roofline.selfplay: kernel B (``takzero_torch/ops/simhash.py``,
``csrc/simhash.cu``), the SimHash projection and pack of every evaluated
position, as a share of its bytes bound.

Source: the device slice of the traced move.  Bound: f32 x[B, In] and
M[In, bits] read once, an int64 word a row written once, at 3.35 TB/s,
for each launch; divided by the launches' summed device time.  Cells
without SimHash have no such launch and no reading."""

from benchmark.harness.counts import roofline_share, simhash_bytes
from benchmark.harness.trace import matching

SOURCE = "device_trace"
SLICE = "device"
PATTERNS = (r"\bsimhash_kernel\b",)


def read(trace):
    sl = trace.slices.get(SLICE)
    shape = trace.shapes.get("simhash")
    if sl is None or shape is None:
        return None
    ev = matching(sl.device, PATTERNS)
    return roofline_share(len(ev), simhash_bytes(*shape), sum(d for _, _, d in ev) / 1e6)
