"""phase_a_host_ms.serve: host milliseconds per serve chunk in phase A,
the wavefront's descent (``search/serve.py``'s ``serve_chunk.A`` range).

Source: the program's own ``record_function`` range in the host slice of
the traced commands.  Recording host operators slows the host, so the
range's share of the slice's wall time is taken, times the unprofiled
wall time per ``go`` of the window (one chunk a ``go``)."""

SOURCE = "program_span"
SLICE = "host"
RANGE = "serve_chunk.A"


def read(trace):
    sl = trace.slices.get(SLICE)
    units, seconds = trace.window.get("units"), trace.window.get("seconds")
    spans = [d for name, _, d, _ in (sl.host if sl is not None else []) if name == RANGE]
    if not spans or not units or not sl.wall_s:
        return None
    share = sum(spans) / 1e6 / sl.wall_s
    return 1e3 * share * seconds / units
