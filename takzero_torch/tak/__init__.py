from .engine import TakEngine, engine
from .moves import (
    ActionSpace,
    action_space,
    action_to_ptn,
    count_possible_moves,
    ptn_to_action,
)
from .state import TakState, initial_state_batch

__all__ = [
    "ActionSpace",
    "TakEngine",
    "TakState",
    "action_space",
    "action_to_ptn",
    "count_possible_moves",
    "engine",
    "initial_state_batch",
    "ptn_to_action",
]
