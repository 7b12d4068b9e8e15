"""spacer_tpu_torch — the PyTorch / CUDA port of spacer_tpu for NVIDIA Hopper.

The JAX package `spacer_tpu` stays the reference; this package imports
torch and numpy, never jax or spacer_tpu.  First slice: the video-QA serving
path (processor -> ViT -> prefill -> continuous-batching decode -> sample),
with the four Pallas kernels of that path rewritten as CUDA C++ for sm_90a
(spacer_tpu_torch/csrc, built by nvcc on first use).

Subpackages mirror spacer_tpu: nn, ops, models.qwen25_vl, vision, data,
sampler, serving, evalharness, cli.
"""

__version__ = "0.1.0"
