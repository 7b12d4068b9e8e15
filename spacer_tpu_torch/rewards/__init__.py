# Copied from spacer_tpu/rewards/__init__.py; only its imports point at spacer_tpu_torch.
"""Verifiable reward functions (host-side, pure Python).

Behavioral reference: SG-RLVR.py:57-250 (accuracy/format rewards + registry)
and extract_map.py (cognitive-map parsing + scoring).  Rewards run on host
between rollout and loss — they are the RL environment, so their semantics
(including clamps, fallbacks-to-zero and the map-score bonus) must match the
reference exactly.
"""

from spacer_tpu_torch.rewards.extract import extract_answer, extract_map_tag
from spacer_tpu_torch.rewards.cogmap import (
    extract_map_data,
    calculate_prediction_score,
    compute_map_score,
)
from spacer_tpu_torch.rewards.accuracy import (
    accuracy_reward,
    fuzzy_matching,
    mean_relative_accuracy,
    word_error_rate,
)
from spacer_tpu_torch.rewards.format import format_reward
from spacer_tpu_torch.rewards.registry import REWARD_REGISTRY, get_reward_funcs

__all__ = [
    "extract_answer", "extract_map_tag",
    "extract_map_data", "calculate_prediction_score", "compute_map_score",
    "accuracy_reward", "fuzzy_matching", "mean_relative_accuracy",
    "word_error_rate", "format_reward", "REWARD_REGISTRY", "get_reward_funcs",
]
