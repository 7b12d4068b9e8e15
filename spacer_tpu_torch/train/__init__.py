"""Training: the GRPO / SG-RLVR step, optimizer and trainer loop
(counterpart of spacer_tpu/train)."""

from spacer_tpu_torch.train.grpo import (
    group_advantages,
    grpo_loss,
    length_control_bonus,
    per_token_logps_from_logits,
    temporal_bonus,
)
from spacer_tpu_torch.train.optimizer import make_optimizer

__all__ = ["grpo_loss", "group_advantages", "per_token_logps_from_logits",
           "temporal_bonus", "length_control_bonus", "make_optimizer"]
