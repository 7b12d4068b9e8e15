# Copied from spacer_tpu/rewards/registry.py; only its imports point at spacer_tpu_torch.
"""Reward function registry (SG-RLVR.py:247-250 equivalent)."""

from __future__ import annotations

from spacer_tpu_torch.rewards.accuracy import accuracy_reward
from spacer_tpu_torch.rewards.format import format_reward

REWARD_REGISTRY = {
    "accuracy": accuracy_reward,
    "format": format_reward,
}


def get_reward_funcs(names):
    return [REWARD_REGISTRY[n] for n in names]
