"""evaluator_host_ms.selfplay: host milliseconds per batched simulation in
the evaluator call (the ``search.evaluate`` span of ``search/core.py``):
planes, the tower and heads (``models/network.py``), SimHash and the
seen-set or the RND (``models/agent.py``).

Source: the program's own span in the host slice of the traced move, its
self time, scaled to the unprofiled window (``harness/spans.py``).  The
slice opens and closes inside an evaluator call (the harness counts
simulations there): its first evaluation runs outside the span and its
last span is cut where the slice ends, so the reading holds one whole
evaluation fewer than the slice has simulations."""

from benchmark.harness.spans import host_ms_per_unit

SOURCE = "program_span"
SPAN = "search.evaluate"


def read(trace):
    return host_ms_per_unit(trace, SPAN)
