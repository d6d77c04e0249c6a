"""Step-windowed tracing with ``torch.profiler``.

Counterpart of ``takzero_tpu/utils/profile.py``.  :class:`StepTrace` wraps
a driver's loop: it skips the first iteration(s), so that building kernels
and warming caches do not fill the trace, records a fixed window, and
writes a Chrome trace (``chrome://tracing``, Perfetto) into a directory.
"""

from __future__ import annotations

import os
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile


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
