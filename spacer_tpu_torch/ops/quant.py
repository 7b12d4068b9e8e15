"""Weight-only int8 / int4 and int8 KV quantization for the decode path
(counterpart of spacer_tpu/ops/quant.py).

Decode streams every weight once per generated token, so fewer weight bytes
are a shorter step.  Rollouts and serving quantize the decode loop only:
prefill, logps and updates stay in the params' dtype, so quantization
perturbs the sampling distribution, not the gradient estimator.

Param convention (the JAX package's): a quantized dense dict carries
"kernel_q8" (int8, the kernel's shape) and "q8_scale" (f32 (..., 1, N)), or
"kernel_q4" (packed int4 (..., K/2, N), ops/int4_matmul.py), "q4_row_scale"
(f32 (..., K)) and "q4_col_scale" (f32 (..., N)); nn.core.dense dispatches
on the key.  Rounding is torch.round (half to even, as jnp.round) with the
same max(scale, 1e-12) guard, so codes equal JAX's.

Under tensor parallelism (parallel/tp.py) each rank quantizes its slice of
a kernel, and a scale that reduces over a dim the slice cuts is max-reduced
over tp before rounding (JAX's scales are the whole tensor's under GSPMD):
the int8 and int4 column scales of a row-parallel kernel (o_proj,
down_proj: K is cut), the int4 row scale of a column-parallel one (N is
cut).  A rank's codes and scales are then the slice of one process's.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.ops import _build
from spacer_tpu_torch.ops.int4_matmul import (
    dense_q4_fused,
    int4_matmul_reference,
    pack_int4,
)
from spacer_tpu_torch.parallel import tp

# row-parallel products (their K is the one tp cuts); the rest are
# column-parallel
_ROW_PARALLEL = ("o_proj", "down_proj")


def quantize_dense_int8(p, row_parallel: bool = False):
    """{"kernel": (..., in, out), [bias]} -> int8 weight dict.
    Per-output-channel symmetric: scale[j] = max_i |w[..., i, j]| / 127
    (the max over tp too for a row-parallel slice).  Already-quantized
    dicts pass through."""
    if "kernel_q8" in p:
        return p
    k = p["kernel"].float()
    scale = k.abs().amax(dim=-2, keepdim=True)
    if row_parallel:
        scale = tp.all_max(scale)
    scale = scale / 127.0
    q = torch.round(k / scale.clamp_min(1e-12))
    out = {"kernel_q8": q.clamp(-127, 127).to(torch.int8), "q8_scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def dense_q8(params, x):
    """y = (x @ dequant(kernel)) [+ bias].  JAX leaves this product to XLA,
    which fuses the int8 -> activation-dtype convert into the matmul; here
    the convert materialises a copy of the kernel in x's dtype per call
    (its cost is measured by chip_smoke.py)."""
    y = torch.matmul(x, params["kernel_q8"].to(x.dtype))
    y = y * params["q8_scale"].to(y.dtype)
    if "bias" in params:
        y = y + params["bias"]
    return y


def quantize_dense_int4(p, row_parallel: bool = False):
    """{"kernel": (..., K, N), [bias]} -> packed int4 weight dict.
    Rank-1-scaled symmetric 4-bit: w ~ q * row_scale[k] * col_scale[n] with
    codes in [-7, 7]; the row scale folds into the activation, the column
    scale into the output, so the packed matmul (K6) is scale-free.  Under
    tp the column scale of a row-parallel slice and the row scale of a
    column-parallel one are max-reduced over tp."""
    if "kernel_q4" in p:
        return p
    k = p["kernel"].float()
    col = k.abs().amax(dim=-2, keepdim=True)                 # (..., 1, N)
    if row_parallel:
        col = tp.all_max(col)
    u = k / col.clamp_min(1e-12)
    row = u.abs().amax(dim=-1, keepdim=True)                 # (..., K, 1)
    if not row_parallel:
        row = tp.all_max(row)
    q = torch.round(7.0 * u / row.clamp_min(1e-12))
    out = {
        "kernel_q4": pack_int4(q.clamp(-7, 7).to(torch.int8)),
        "q4_row_scale": row[..., 0],                          # (..., K)
        "q4_col_scale": col[..., 0, :] / 7.0,                 # (..., N)
    }
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def dense_q4(params, x):
    """y = (x @ dequant_int4(kernel)) [+ bias] in the JAX order: the row
    scale multiplies x in x's dtype, the product contracts in bf16 with f32
    sums, then the f32 column scale, the cast to x's dtype, the bias.  On
    CUDA tensors all of it is one K6 launch (ops/int4_matmul.py
    dense_q4_fused: bf16 x and bias); on the CPU its plain composition,
    dense_q4_reference.  JAX pads M to a multiple of 8 for the TPU's tiles;
    the CUDA kernel masks M itself."""
    if _build.takes_plain(x, "K6"):
        return dense_q4_reference(params, x)
    *lead, K = x.shape
    y = dense_q4_fused(x.view(-1, K), params["kernel_q4"],
                       params["q4_row_scale"], params["q4_col_scale"],
                       params.get("bias"))
    return y.view(*lead, y.shape[-1])


def dense_q4_reference(params, x):
    """Plain version of dense_q4: the composition above in PyTorch ops, the
    product by K6's plain version (int4_matmul_reference)."""
    packed = params["kernel_q4"]
    *lead, K = x.shape
    N = packed.shape[-1]
    xs = (x * params["q4_row_scale"].to(x.dtype)).reshape(-1, K)
    y = int4_matmul_reference(xs, packed)
    y = (y * params["q4_col_scale"].float()).to(x.dtype).reshape(*lead, N)
    if "bias" in params:
        y = y + params["bias"]
    return y


def quantize_kv(x):
    """(..., Dh) KV block -> (int8 codes, f32 per-vector scale (...)).
    The scale never enters the attention products: K scales multiply the
    logits, V scales the softmax probabilities (K2-int8 / K5-int8)."""
    a = x.float().abs().amax(dim=-1)
    scale = a / 127.0
    q = torch.round(x.float() / scale.clamp_min(1e-12)[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def _is_dense(node) -> bool:
    return isinstance(node, dict) and "kernel" in node


def _quantize_tree(tree, quant, skip_names):
    def walk(node, skip, name=""):
        if skip:
            return node
        if _is_dense(node):
            return quant(node, name in _ROW_PARALLEL)
        if isinstance(node, dict):
            return {k: walk(v, k in skip_names, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, False) for v in node)
        return node

    return walk(tree, False)


def quantize_tree_int8(tree, skip_names=("router", "experts")):
    """Quantize every dense kernel in a param subtree (a dict, or the port's
    list of per-layer dicts).  Subtrees under `skip_names` (the MoE router
    and grouped-GEMM experts) stay full precision."""
    return _quantize_tree(tree, quantize_dense_int8, skip_names)


def quantize_tree_int4(tree, skip_names=("router", "experts")):
    """int4 variant of quantize_tree_int8 (same skip list); kernels whose
    input dim is odd stay int8 (packing needs even K)."""
    def quant(p, row_parallel=False):
        if p["kernel"].shape[-2] % 2:
            return quantize_dense_int8(p, row_parallel)
        return quantize_dense_int4(p, row_parallel)

    return _quantize_tree(tree, quant, skip_names)


def quantize_decode_weights(layer_params, lm_head, bits: int = 8):
    """Quantize the decode-path weights in one place: the decoder layers
    plus, when untied, the lm_head dense, with the MoE skip list; the rollout
    sampler and the serving batcher reach it through quantize_decode_model.
    bits=8 or 4.  Returns (layer_params_q, lm_head_q)."""
    tree_q = {8: quantize_tree_int8, 4: quantize_tree_int4}[bits]
    layer_params = tree_q(layer_params)
    if lm_head is not None:
        dense_q = {8: quantize_dense_int8, 4: quantize_dense_int4}[bits]
        if bits == 4 and lm_head["kernel"].shape[-2] % 2:
            dense_q = quantize_dense_int8
        lm_head = dense_q(lm_head)
    return layer_params, lm_head


def quantize_decode_model(model, decode_quant):
    """The LM params a decode loop reads under `decode_quant`: the layers and
    an untied lm_head quantized ("int8*": int8, "int4*": int4), every other
    entry shared with `model`; None -> `model` itself."""
    if decode_quant is None:
        return model
    layers, head = quantize_decode_weights(
        model["layers"], model.get("lm_head"),
        bits=4 if decode_quant.startswith("int4") else 8)
    out = dict(model, layers=layers)
    if head is not None:
        out["lm_head"] = head
    return out
