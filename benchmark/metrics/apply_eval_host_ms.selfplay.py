"""apply_eval_host_ms.selfplay: host milliseconds per batched simulation
in the search's expansion (``search/core.py`` ``apply_eval``, the
``search.apply_eval`` span): leaf statistics, the masked top-k (kernel A)
and the new rows' stores.

Source: the program's own span in the host slice of the traced move, its
self time, scaled to the unprofiled window (``harness/spans.py``)."""

from benchmark.harness.spans import host_ms_per_unit

SOURCE = "program_span"
SPAN = "search.apply_eval"


def read(trace):
    return host_ms_per_unit(trace, SPAN)
