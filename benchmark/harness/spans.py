"""Self time of the program's spans in a traced slice, per unit of the
window.

The program names its phases with ``torch.profiler`` ranges
(``takzero_torch/utils/profile.py`` ``span``), and each blocking read of
the device with a ``sync`` range.  A span's self time is its duration less
the ``sync`` spans inside it, on the thread that ran most host events.
Recording host events slows the host, so the readers take the self time's
share of the slice's wall time, times the unprofiled wall time per unit of
the window: ``phase_a_host_ms.serve``'s method.
"""

from __future__ import annotations

SYNC = "sync"
HOST_SLICE = "host"


def main_thread(host) -> int | None:
    """The thread that ran most host events of a slice."""
    threads: dict = {}
    for h in host:
        threads[h[3]] = threads.get(h[3], 0) + 1
    return max(threads, key=threads.get) if threads else None


def self_us(host, name: str) -> float | None:
    """Summed self time, in microseconds, of the spans called ``name`` on
    the main thread; ``None`` where there is none."""
    main = main_thread(host)
    on_main = [(n, s, s + d) for n, s, d, t in host if t == main]
    spans = [e for e in on_main if e[0] == name]
    if not spans:
        return None
    syncs = [e for e in on_main if e[0] == SYNC]
    total = 0.0
    for sp in spans:
        _, start, end = sp
        inner = sum(e - s for _, s, e in (x for x in syncs if x is not sp) if start <= s and e <= end)
        total += end - start - inner
    return total


def host_ms_per_unit(trace, name: str) -> float | None:
    """Host milliseconds per unit of the window in the spans called
    ``name``; ``None`` without a host slice, a window or the span."""
    sl = trace.slices.get(HOST_SLICE)
    units, seconds = trace.window.get("units"), trace.window.get("seconds")
    if sl is None or not units or not seconds or not sl.wall_s:
        return None
    us = self_us(sl.host, name)
    if us is None:
        return None
    return 1e3 * (us / 1e6 / sl.wall_s) * seconds / units
