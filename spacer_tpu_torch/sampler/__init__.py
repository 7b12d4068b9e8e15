"""Sampling: token sampling, the vision prologue and the grouped rollout."""

from spacer_tpu_torch.sampler.sampler import (
    SampleOutput,
    Sampler,
    filtered_logits,
    sample_logits,
)

__all__ = ["SampleOutput", "Sampler", "filtered_logits", "sample_logits"]
