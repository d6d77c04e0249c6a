"""graph_launches_per_sim.selfplay: CUDA graph launches per batched
simulation: the middles of the search's simulations replayed from CUDA
graphs (``search/core.py`` ``_SearchGraphs``), three a simulation where the
evaluator is captured and two where it runs eagerly; 0 where the search
dispatches every operator from Python.

Source: the host slice of the traced move, the ``cudaGraphLaunch`` calls
of the CUDA runtime on the thread that ran most host events, over the
simulations of the slice."""

from benchmark.harness.spans import HOST_SLICE, main_thread

SOURCE = "device_trace"
PREFIX = "cudaGraphLaunch"


def read(trace):
    sl = trace.slices.get(HOST_SLICE)
    if sl is None or not sl.host or not sl.units:
        return None
    main = main_thread(sl.host)
    return sum(1 for name, _, _, t in sl.host if t == main and name.startswith(PREFIX)) / sl.units
