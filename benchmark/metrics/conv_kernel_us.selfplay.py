"""conv_kernel_us.selfplay: device microseconds per batched simulation in
the evaluator's convolution kernel (``takzero_torch/ops/conv.py``,
``csrc/conv.cu``): the stem, every tower layer and the policy head, one
launch each, ``2 blocks + 2`` an evaluation of every game's leaf.

Source: the device slice of the traced move, the summed device time of the
kernel's launches over the simulations of the slice.  A program whose
evaluator convolves through a library instead has no such kernel, and the
reader then reads nothing."""

from benchmark.harness.trace import matching

SOURCE = "device_trace"
SLICE = "device"
PATTERNS = (r"\bconv3x3_bf16_kernel\b",)


def read(trace):
    sl = trace.slices.get(SLICE)
    if sl is None or not sl.units:
        return None
    ev = matching(sl.device, PATTERNS)
    if not ev:
        return None
    return sum(d for _, _, d in ev) / sl.units
