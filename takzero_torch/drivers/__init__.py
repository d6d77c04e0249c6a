"""Command-line drivers: ``learn``, ``selfplay``, ``reanalyze``, ``coscheduled``,
``evaluation``, ``puzzle``, ``tei`` and ``analysis``."""

from __future__ import annotations

import os

from ..config import NOT_PORTED_PRESETS


def refuse_unported(args) -> None:
    """Raise for the launches and nets the port has not got yet."""
    if args.devices is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "takzero_torch runs on one device: --devices and multihost runs are not "
            "ported yet (ROADMAP.md queue 1, item 5)"
        )
    if args.net in NOT_PORTED_PRESETS:
        raise NotImplementedError(
            f"--net {args.net}: takzero_torch ports the simhash and none novelty variants; "
            "RND, ensemble and lcghash nets are not ported yet"
        )
