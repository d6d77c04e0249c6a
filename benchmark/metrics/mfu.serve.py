"""mfu.serve: the evaluator's model FLOPs over the window as a share of
the H100's 989 TFLOP/s in bf16.

Source: the unprofiled window of the traced run: a chunk of N nodes
evaluates N positions (one plain simulation and N - 1 wavefront leaves),
``harness/counts.py``'s ``evaluator_flops`` each, over the window's
seconds."""

from benchmark.harness.counts import PEAK_BF16_FLOPS, evaluator_flops

SOURCE = "host_clock"


def read(trace):
    rows, seconds = trace.counts.get("evaluated_rows"), trace.window.get("seconds")
    if not rows or not seconds:
        return None
    return 100.0 * evaluator_flops(trace.cfg) * rows / seconds / PEAK_BF16_FLOPS
