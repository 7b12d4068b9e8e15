"""Core functional layers on torch tensors (counterpart of spacer_tpu/nn/core.py).

Params are plain dicts of tensors with the JAX package's layouts:
- dense kernel: (in_features, out_features); HF stores (out, in).
- embedding: (vocab, dim).
- rms_norm / layer_norm scale: (dim,).
"""

from __future__ import annotations

import torch


def dense_init(in_dim: int, out_dim: int, use_bias: bool = True, *,
               generator: torch.Generator | None = None,
               dtype=torch.float32, device=None, scale: float | None = None):
    """Truncated normal in [-2, 2] sigma, sigma = in_dim**-0.5 by default
    (the scale of spacer_tpu's dense_init).  Drawn in float32 on `device`,
    then cast."""
    if scale is None:
        scale = in_dim ** -0.5
    kernel = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    p = {"kernel": kernel.mul_(scale).to(dtype)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense(params, x):
    if "kernel_q8" in params:  # weight-only int8 (ops/quant.py)
        from spacer_tpu_torch.ops.quant import dense_q8

        return dense_q8(params, x)
    if "kernel_q4" in params:  # packed int4 (ops/quant.py + K6)
        from spacer_tpu_torch.ops.quant import dense_q4

        return dense_q4(params, x)
    y = torch.matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"]
    return y


def embed_init(vocab: int, dim: int, *, generator=None, dtype=torch.float32,
               device=None):
    table = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    table.normal_(0.0, 0.02, generator=generator)
    return {"embedding": table.to(dtype)}


def embed(params, ids):
    """Table lookup; with tensor parallelism active the table is this
    rank's vocabulary slice and the lookup vocab-parallel
    (parallel/tp.embed)."""
    from spacer_tpu_torch.parallel import tp

    if tp.active():
        return tp.embed(params["embedding"], ids)
    return params["embedding"][ids]


def rms_norm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def layer_norm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(params, x, eps: float = 1e-6):
    """LayerNorm with float32 statistics."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (params["scale"] * x.to(dtype) + params["bias"]).to(dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def rms_norm(params, x, eps: float = 1e-6):
    """RMSNorm with float32 statistics (Qwen2RMSNorm numerics)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (params["scale"] * x.to(dtype)).to(dtype)
