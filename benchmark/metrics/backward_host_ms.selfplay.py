"""backward_host_ms.selfplay: host milliseconds per batched simulation in
the search's backup (``search/core.py`` ``backward``, the ``search.backward``
span): every level's gathers, solver and row write-backs.

Source: the program's own span in the host slice of the traced move, its
self time (less the ``sync`` span of the ``jmax`` read), scaled to the
unprofiled window (``harness/spans.py``)."""

from benchmark.harness.spans import host_ms_per_unit

SOURCE = "program_span"
SPAN = "search.backward"


def read(trace):
    return host_ms_per_unit(trace, SPAN)
