"""Continuous-batching serving engine and its OpenAI-compatible HTTP front
end (counterpart of spacer_tpu/serving)."""

from spacer_tpu_torch.serving.batcher import ContinuousBatcher, ServedOutput
from spacer_tpu_torch.serving.ragged import ragged_decode_step
from spacer_tpu_torch.serving.server import OpenAIServer, ServingLoop

__all__ = ["ContinuousBatcher", "ServedOutput", "ragged_decode_step",
           "OpenAIServer", "ServingLoop"]
