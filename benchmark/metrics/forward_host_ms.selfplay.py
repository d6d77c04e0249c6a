"""forward_host_ms.selfplay: host milliseconds per batched simulation in
the search's descent (``search/core.py`` ``forward``, the ``search.forward``
span): the level loop's gathers, PUCT scores and path writes, the leaf's
step and terminal check.

Source: the program's own span in the host slice of the traced move, its
self time (less the ``sync`` spans of the per-level ``active.any()``
reads), scaled to the unprofiled window (``harness/spans.py``)."""

from benchmark.harness.spans import host_ms_per_unit

SOURCE = "program_span"
SPAN = "search.forward"


def read(trace):
    return host_ms_per_unit(trace, SPAN)
