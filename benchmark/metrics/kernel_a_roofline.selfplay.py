"""kernel_a_roofline.selfplay: kernel A (``takzero_torch/ops/topk.py``,
``csrc/topk.cu``), the expansion's top-k over the masked logits, as a
share of its bytes bound.

Source: the device slice of the traced move.  Bound: f32[B, A] read
once, f32 values and i32 indices [B, k] written once, at 3.35 TB/s, for
each launch of the kernel's names; divided by their summed device time."""

from benchmark.harness.counts import roofline_share, topk_bytes
from benchmark.harness.trace import matching

SOURCE = "device_trace"
SLICE = "device"
PATTERNS = (r"\btopk_rows_kernel\b", r"\btopk_wide_kernel\b")


def read(trace):
    sl = trace.slices.get(SLICE)
    shape = trace.shapes.get("topk")
    if sl is None or shape is None:
        return None
    ev = matching(sl.device, PATTERNS)
    return roofline_share(len(ev), topk_bytes(*shape), sum(d for _, _, d in ev) / 1e6)
