"""sync_wait_ms.selfplay: host milliseconds per batched simulation spent
waiting on blocking device-to-host reads (every ``sync`` span: the
descent's per-level ``active.any()`` and the backup's ``jmax``).

Source: the program's own spans in the host slice of the traced move,
summed, scaled to the unprofiled window (``harness/spans.py``).  Their
count per simulation is ``host_syncs_per_sim.selfplay``'s, read from the
device's copies."""

from benchmark.harness.spans import host_ms_per_unit

SOURCE = "program_span"
SPAN = "sync"


def read(trace):
    return host_ms_per_unit(trace, SPAN)
