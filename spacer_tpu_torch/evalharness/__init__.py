"""Inference engine of the evaluation and serving paths (counterpart of
spacer_tpu/evalharness; the benchmark runners are not ported yet)."""

from spacer_tpu_torch.evalharness.engine import QwenEngine

__all__ = ["QwenEngine"]
