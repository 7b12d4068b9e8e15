# Copied from spacer_tpu/evalharness/benchmarks/__init__.py; only its imports point at spacer_tpu_torch.
"""Per-benchmark eval workers and scorers."""

from spacer_tpu_torch.evalharness.benchmarks import (  # noqa: F401
    vsibench,
    stibench,
    sparbench,
    videomme,
    longvideobench,
    tempcompass,
)
