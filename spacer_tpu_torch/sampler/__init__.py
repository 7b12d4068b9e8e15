"""Sampling for serving (counterpart of spacer_tpu/sampler)."""

from spacer_tpu_torch.sampler.sampler import filtered_logits, sample_logits

__all__ = ["filtered_logits", "sample_logits"]
