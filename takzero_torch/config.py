"""Preset configurations, as in ``takzero_tpu/config.py``.

Only the presets whose novelty variant the port has (``simhash``,
``none``) are listed; the others come with later slices.
"""

from __future__ import annotations

from .models.network import NetConfig
from .selfplay import SelfplayConfig

NET_PRESETS: dict[str, NetConfig] = {
    "net4_simhash": NetConfig(n=4, half_komi=4, novelty="simhash", hash_bits=32),
    "net6_simhash": NetConfig(n=6, half_komi=4, novelty="simhash", hash_bits=32),
    "net4_plain": NetConfig(n=4, half_komi=4, novelty="none"),
    "tiny3": NetConfig(n=3, half_komi=0, filters=16, blocks=2, novelty="simhash", hash_bits=12),
}


def selfplay_preset(net: str, **overrides) -> SelfplayConfig:
    """Reference selfplay constants (256 child slots from 6x6 up)."""
    defaults = dict(
        batch=128,
        beta=0.25,
        exploration=False,
        weighted_random_plies=10,
        sampled_actions=64,
        search_budget=768,
        max_children=256 if NET_PRESETS[net].n >= 6 else 128,
        max_depth=48,
    )
    defaults.update(overrides)
    return SelfplayConfig(**defaults)
