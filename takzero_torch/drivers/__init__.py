"""Command-line drivers: ``learn``, ``selfplay``, ``reanalyze``, ``coscheduled``,
``evaluation``, ``puzzle``, ``tei`` and ``analysis``."""

from __future__ import annotations

import os


def refuse_unported(args) -> None:
    """Raise for the launches the port has not got yet: several devices."""
    if args.devices is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "takzero_torch runs on one device: --devices and multihost runs are not "
            "ported yet (ROADMAP.md queue 1, item 5)"
        )
