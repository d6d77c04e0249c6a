"""Preset configurations, as in ``takzero_tpu/config.py``: the
reference's network variants (takzero/src/network/*.rs) and the small
configurations of the tests, each taken by every driver's ``--net``."""

from __future__ import annotations

from dataclasses import dataclass

from .models.network import NetConfig
from .selfplay import SelfplayConfig

NET_PRESETS: dict[str, NetConfig] = {
    # net4_rnd.rs: 4x4, 16x256 core, conv-tower RND
    "net4_rnd": NetConfig(n=4, half_komi=4, filters=256, blocks=16, novelty="rnd"),
    # net5.rs: 5x5, 20 residual blocks, MLP RND
    "net5": NetConfig(n=5, half_komi=4, filters=256, blocks=20, novelty="rnd", rnd_mlp=True),
    # net4_simhash.rs / net6_simhash.rs: SimHash novelty over a 2^32 bitset
    "net4_simhash": NetConfig(n=4, half_komi=4, novelty="simhash", hash_bits=32),
    "net6_simhash": NetConfig(n=6, half_komi=4, novelty="simhash", hash_bits=32),
    # net4_lcghash.rs: LCG-hash novelty
    "net4_lcghash": NetConfig(n=4, half_komi=4, novelty="lcghash", hash_bits=32),
    # net4_ensemble.rs: 16 extra value heads
    "net4_ensemble": NetConfig(n=4, half_komi=4, novelty="ensemble"),
    # a plain net (no novelty)
    "net4_plain": NetConfig(n=4, half_komi=4, novelty="none"),
    # small test configurations
    "tiny3": NetConfig(n=3, half_komi=0, filters=16, blocks=2, novelty="simhash", hash_bits=12),
    "tiny3_rnd": NetConfig(n=3, half_komi=0, filters=16, blocks=2, novelty="rnd", rnd_filters=8, rnd_blocks=1),
    # 4x4 at the board and komi of net4_*, with a small tower
    "tiny4": NetConfig(n=4, half_komi=4, filters=32, blocks=4, novelty="lcghash", hash_bits=24),
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


@dataclass(frozen=True)
class LearnConfig:
    """learn/src/main.rs:42-65."""

    batch_size: int = 128
    steps_per_save: int = 100
    steps_per_checkpoint: int = 50_000
    learning_rate: float = 1e-4
    initial_random_targets: int = 128 * 2_000
    pre_training_steps: int = 1_000
    steps_before_reanalyze: int = 5_000
    min_selfplay_buffer: int = 10_000
    min_reanalyze_buffer: int = 2_000
    selfplay_forced_uses: int = 4
    reanalyze_forced_uses: int = 4
    min_seconds_between_reads: float = 10.0
    sleep_when_starved: float = 30.0


@dataclass(frozen=True)
class ReanalyzeConfig:
    """reanalyze/src/main.rs:33-49."""

    batch_size: int = 128
    min_positions: int = 128_000
    max_reanalyze_buffer: int = 32_000
    sampled_actions: int = 64
    search_budget: int = 768
    max_children: int = 128
    max_depth: int = 48
    ube_target_beta: float = 0.25


MAX_SELFPLAY_BUFFER_LEN = 32_000  # backpressure (selfplay:43)
