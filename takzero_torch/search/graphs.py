"""One search's simulations replayed from CUDA graphs.

On a CUDA tree a simulation makes no host read (``search/core.py``), so
within one search (``simulate.search_scope``, which the Gumbel search opens)
its phases are captured into CUDA graphs in the second simulation and
replayed in every later one (:class:`SearchGraphs`).  No counterpart in
JAX, whose whole search is one compiled program.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from ..ops import _build
from .tree import Tree

# Simulations run in this process, by how their phases ran: eagerly,
# captured into a search's CUDA graphs (and replayed once), or replayed.
MIDDLES = {"eager": 0, "captured": 0, "replayed": 0}


def _captured(fn: Callable, pool, stream: torch.cuda.Stream):
    """(graph, outputs): ``fn``'s device work captured on ``stream`` into
    ``pool``, not run."""
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    main.wait_stream(stream)
    return graph, out


@functools.lru_cache(maxsize=None)
def _capture_resources(index: int):
    """(memory pool, side stream, keeper) of the search graphs on CUDA
    device ``index``, one set for the process, so that each search captures
    into the memory its predecessor's graphs left free.  The keeper, the
    pool's first graph (one fill, never replayed), holds the pool open
    between searches: a pool whose graphs are all released takes no further
    capture."""
    with torch.cuda.device(index):
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        keeper, _ = _captured(lambda: torch.zeros((1,), device=f"cuda:{index}"), pool, stream)
    return pool, stream, keeper


class SearchGraphs:
    """The phases of one search's simulations on a CUDA device.

    The first simulation runs eagerly, which builds the kernels and warms
    cuDNN's algorithm choice, kernels A's and B's one-time attributes and
    the engine's device tables.  Each later simulation replays a CUDA
    graph of each phase, captured at its first use in one shared pool, on
    a side stream: the forward (the descent kernel and ``settle``), the
    evaluator where it is ``capturable``, ``apply_eval`` and the backward
    (the backup kernel).  The graphs fix ``skip_root`` and whether a slot
    is forced as the capture found them (the Gumbel search's simulations
    after its first are all forced under ``skip_root``), and a later
    simulation that differs raises.  An evaluator that is not capturable runs
    eagerly, and its outputs are copied to fixed addresses for the later
    graphs.  Every input the graphs read lies at a fixed address: the
    tree, ``beta`` and the forced slot (copied into ``beta`` and
    ``forced`` each simulation), the descent's outputs (``loop``, given)
    and each graph's outputs; stream order keeps each replay behind the
    reads of the last.  A replay adds to the launch counters
    (``_build.launch_counts``) the launches its capture counted.
    """

    def __init__(self, tree: Tree, loop: dict, capture_evaluator: bool):
        dev = tree.child_visit.device
        b = tree.batch_size
        self.tree = tree
        self.loop = loop
        self.beta = torch.empty((b,), dtype=torch.float32, device=dev)
        self.forced = torch.empty((b,), dtype=torch.int64, device=dev)
        self.capture_evaluator = capture_evaluator
        self.pool, self.stream, _ = _capture_resources(dev.index)
        self.sims = 0
        self.variant = None  # (skip_root, no forced slot) of the graphed simulations
        self.graphs: dict = {}  # phase -> (graph, its outputs, launches it adds)
        self.static = None  # an eager evaluator's outputs at fixed addresses

    def check(self, tree: Tree, skip_root: bool, unforced: bool) -> None:
        if tree is not self.tree:
            raise ValueError("a search scope's simulations must search the tree it was opened on")
        if self.sims == 0:
            return
        if self.variant is None:
            self.variant = (skip_root, unforced)
        elif self.variant != (skip_root, unforced):
            raise ValueError(f"a search scope's graphs were captured with (skip_root, no forced slot) = "
                             f"{self.variant}, not {(skip_root, unforced)}")

    def inputs(self, beta, forced_slot) -> tuple:
        """(beta, forced slot or None) at the fixed addresses the graphs
        read: ``beta`` a number or a tensor that broadcasts to [B]."""
        if isinstance(beta, torch.Tensor):
            self.beta.copy_(beta)
        else:
            self.beta.fill_(float(beta))
        if forced_slot is None:
            return self.beta, None
        return self.beta, self.forced.copy_(forced_slot)

    def run(self, phase: str, fn: Callable):
        if self.sims == 0:
            return fn()
        if phase == "evaluate" and not self.capture_evaluator:
            out = fn()
            if self.static is None:
                self.static = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in out)
            for dst, src in zip(self.static, out):
                dst.copy_(src)
            return self.static
        if phase in self.graphs:
            graph, out, added = self.graphs[phase]
            _build.add_launches(added)
        else:  # the capture counted this simulation's launches
            graph, out, _ = self.graphs[phase] = self._capture(fn)
        graph.replay()
        return out

    def _capture(self, fn: Callable):
        before = _build.launch_counts()
        graph, out = _captured(fn, self.pool, self.stream)
        after = _build.launch_counts()
        return graph, out, {k: n - before[k] for k, n in after.items() if n != before[k]}

    def end_simulation(self) -> str:
        """The engagement of the simulation that ends (``MIDDLES``' key)."""
        self.sims += 1
        return "eager" if self.sims == 1 else "captured" if self.sims == 2 else "replayed"

    def close(self) -> None:
        graphs, self.graphs, self.static, self.loop, self.tree = self.graphs, {}, None, None, None
        self.beta = self.forced = None
        for graph, _, _ in graphs.values():
            graph.reset()
