"""Map a spacer_tpu (JAX) parameter tree of either family (Qwen2.5-VL /
Qwen2-VL, Aria) into the port's params.

The JAX tree stacks per-layer weights on a leading axis ("layers" of the LM,
"blocks" of the Qwen ViT, "encoder" of the Aria ViT) and stores dense
kernels as (in, out); the port keeps the (in, out) layout and unstacks
those axes into lists of per-layer dicts.
Leaves may be numpy arrays or anything `np.asarray` accepts (a JAX array
included), so this module needs no JAX.  Every parity test builds both
packages' weights this way, so both compute the same function.

Quantization leaves of a pre-quantized tree (ops/quant.py: the int8 codes
"kernel_q8" / "kernel_q4" and the f32 "q8_scale", "q4_row_scale",
"q4_col_scale") keep their own dtype whatever `dtype` asks: JAX's dense_q4
multiplies the f32 column scale, so a cast would change the function.
"""

from __future__ import annotations

import numpy as np
import torch

from spacer_tpu_torch.models.qwen25_vl.language import split_layers

# stacked subtree -> (config part, its depth attribute)
STACKED = {("model", "layers"): ("text", "num_layers"),
           ("visual", "blocks"): ("vision", "depth"),
           ("visual", "encoder"): ("vision", "num_layers")}


def _tensor(x, dtype, device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16 has no torch counterpart
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True, order="C")).to(device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


QUANT_SCALES = ("q8_scale", "q4_row_scale", "q4_col_scale")


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, None if k in QUANT_SCALES else dtype, device)
                for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def params_from_jax(np_tree, cfg, *, dtype=None, device="cpu"):
    """JAX params {"model": ..., "visual": ...[, "projector": ...]} -> port
    params (dtype: cast floating leaves, None keeps each leaf's own)."""
    out = {}
    for top, sub in np_tree.items():
        out[top] = {}
        for name, val in sub.items():
            stacked = STACKED.get((top, name))
            if stacked is None:
                out[top][name] = _convert(val, dtype, device)
                continue
            part, depth_attr = stacked
            n = getattr(getattr(cfg, part), depth_attr)
            out[top][name] = [_convert(layer, dtype, device)
                              for layer in split_layers(val, n)]
    return out
