"""Continuous-batching serving engine (counterpart of spacer_tpu/serving)."""

from spacer_tpu_torch.serving.batcher import ContinuousBatcher, ServedOutput
from spacer_tpu_torch.serving.ragged import ragged_decode_step

__all__ = ["ContinuousBatcher", "ServedOutput", "ragged_decode_step"]
