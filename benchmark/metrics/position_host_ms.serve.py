"""position_host_ms.serve: host milliseconds per ``go`` in TEI's
``position`` command (``drivers/tei.py`` ``cmd_position``, the
``tei.position`` span): the replay of the game's moves and the tree's
descend.

Source: the program's own span in the host slice of the traced commands
(one ``position`` a ``go``), its self time (less the ``sync`` spans of
descend's ``ok`` reads), scaled to the unprofiled window
(``harness/spans.py``)."""

from benchmark.harness.spans import host_ms_per_unit

SOURCE = "program_span"
SPAN = "tei.position"


def read(trace):
    return host_ms_per_unit(trace, SPAN)
