"""mfu.selfplay: the evaluator's model FLOPs over the window as a share of
the H100's 989 TFLOP/s in bf16 (the card's power limit is in the result's
``device``).

Source: the unprofiled window of the traced run: every simulation
evaluates one position per game, ``harness/counts.py``'s
``evaluator_flops`` of the configuration each (tower, heads, and net5's
RND MLPs), over the window's seconds."""

from benchmark.harness.counts import PEAK_BF16_FLOPS, evaluator_flops

SOURCE = "host_clock"


def read(trace):
    rows, seconds = trace.counts.get("evaluated_rows"), trace.window.get("seconds")
    if not rows or not seconds:
        return None
    return 100.0 * evaluator_flops(trace.cfg) * rows / seconds / PEAK_BF16_FLOPS
