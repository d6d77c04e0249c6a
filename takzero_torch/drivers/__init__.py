"""Command-line drivers: ``learn``, ``selfplay``, ``reanalyze``, ``coscheduled``,
``evaluation``, ``puzzle``, ``tei``, ``analysis`` and ``multihost``."""

from __future__ import annotations

import os


def refuse_unported(args) -> None:
    """Raise for several devices in a driver that runs on one, as its JAX
    counterpart does (``tei``, ``analysis``, ``eee``)."""
    if args.devices is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "this driver runs on one device, as in the JAX package: --devices and multihost runs "
            "are for learn, selfplay, reanalyze, coscheduled, evaluation and puzzle"
        )
