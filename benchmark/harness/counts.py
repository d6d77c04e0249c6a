"""Operations and bytes of the measured work, from the configuration's
sizes, and the chip's published peaks.

The bytes of a kernel count each input byte read once and each output
byte written once, whatever the kernel reads again (``chip_smoke.py``'s
bounds, against 3.35 TB/s).  The FLOPs of the evaluator count two per
multiply-add of every convolution and dense layer of the tower, the heads
and, for net5, both MLPs of the RND; elementwise work is left out."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
RND_WIDTHS = (1024, 1024, 512)


def input_channels(n: int) -> int:
    return 4 * n + 12


def num_actions(n: int) -> int:
    return (3 + 4 * (2**n - 2)) * n * n


def evaluator_flops(cfg: dict) -> float:
    """Forward FLOPs of one evaluated position."""
    n, f = cfg["n"], cfg["filters"]
    s = n * n
    conv3 = lambda cin, cout: 2.0 * 9 * cin * cout * s  # noqa: E731
    flops = conv3(input_channels(n), f) + 2 * cfg["blocks"] * conv3(f, f)
    flops += conv3(f, 3 + 4 * (2**n - 2))  # policy
    flops += 2 * (2.0 * f * s + 2.0 * s)  # value and UBE: 1x1 conv, dense
    if cfg["novelty"] == "rnd" and cfg.get("rnd_mlp"):
        dims = (input_channels(n) * s,) + RND_WIDTHS
        flops += 2 * sum(2.0 * a * b for a, b in zip(dims, dims[1:]))  # predictor and target
    return flops


def topk_bytes(rows: int, cols: int, k: int) -> int:
    """Kernel A: f32[rows, cols] read, f32 values and i32 indices [rows, k] written."""
    return 4 * rows * cols + 8 * rows * k


def simhash_bytes(rows: int, width: int, bits: int) -> int:
    """Kernel B: f32 x[rows, width] and M[width, bits] read, an int64 word a row written."""
    return 4 * rows * width + 4 * width * bits + 8 * rows


def roofline_share(calls: int, bytes_per_call: float, device_s: float) -> float | None:
    """Percent of the bytes bound that ``calls`` launches reached in
    ``device_s`` seconds; ``None`` where nothing ran."""
    if calls <= 0 or device_s <= 0:
        return None
    return 100.0 * calls * bytes_per_call / PEAK_HBM_BYTES / device_s
