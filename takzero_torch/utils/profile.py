"""Step-windowed tracing with ``torch.profiler``, and the program's spans.

Counterpart of ``takzero_tpu/utils/profile.py``.  :class:`StepTrace` wraps
a driver's loop: it skips the first iteration(s), so that building kernels
and warming caches do not fill the trace, records a fixed window, and
writes a Chrome trace (``chrome://tracing``, Perfetto) into a directory.

:func:`span` names a phase of the program on the profiler's timeline,
beside the device's events, while a profiler records (``StepTrace``, the
benchmark's traced slices).  The spans, each inside the one that caused it:

* ``selfplay.move`` (``SelfplayEngine.play_move``'s device half, the whole
  search), then ``sync`` (the packed readback), then ``selfplay.host_half``;
* ``search.forward``, ``search.evaluate``, ``search.apply_eval``,
  ``search.backward``: the phases of a simulation (``search/core.py``);
* ``tei.position`` and ``tei.go``: TEI's two commands (``drivers/tei.py``),
  and ``serve_chunk.A``-``D``: the wavefront's phases (``search/serve.py``);
* ``sync``: one blocking device-to-host read and nothing else, so that
  their count is the host's syncs and their time its wait on the device.
"""

from __future__ import annotations

import contextlib
import os
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range called ``name`` while a profiler records;
    otherwise one shared no-op context: about half a microsecond a span on
    the host of an H100 machine, where a bare ``record_function`` costs ten
    (and one small operator eight).

    A range may outlive the profiler it began under, but not into another:
    stopping one profiler and starting the next while a range is open
    corrupts the profiler's state (torch 2.13 on the CPU crashes soon
    after), so a caller that profiles slices does not let two slices meet
    inside a span."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def host_item(x: torch.Tensor):
    """``x.item()``, the blocking read of a one-element device tensor,
    inside a ``sync`` span."""
    with span("sync"):
        return x.item()


class StepTrace:
    """Trace loop iterations ``[skip, skip + steps)``; a no-op when
    ``directory`` is None.

    Call :meth:`step` at the top of every iteration and :meth:`stop`
    after the loop (also safe on an early exit).  The card's kernels are
    traced when ``device`` is a CUDA device.
    """

    def __init__(self, directory, log, device=None, skip: int = 1, steps: int = 3):
        self.dir = None if directory is None else pathlib.Path(directory)
        self.log = log
        self.skip = skip
        self.steps = steps
        self.n = 0
        self.path: pathlib.Path | None = None  # the trace, once written
        activities = [ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._activities = activities
        self._prof = None

    def step(self) -> None:
        if self.dir is None:
            return
        if self.n == self.skip and self._prof is None:
            self._prof = profile(activities=self._activities)
            self._prof.start()
            self.log.info("profiler: tracing %d steps to %s", self.steps, self.dir)
        elif self._prof is not None and self.n >= self.skip + self.steps:
            self.stop()
        self.n += 1

    def stop(self) -> None:
        if self._prof is None:
            return
        if ProfilerActivity.CUDA in self._activities:
            torch.cuda.synchronize()
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"trace_{os.getpid()}_{self.skip}-{self.n}.json"
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        self.log.info("profiler: trace written to %s", self.path)
