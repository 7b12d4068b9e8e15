"""Hand-written Hopper kernels (counterpart of spacer_tpu/ops).  Each wrapper
runs its plain PyTorch version on CPU tensors and launches its CUDA kernel
(csrc/, built by nvcc on first use) on CUDA tensors, counting the launches
in its `.launches` attribute; inside utils.debugging.interpret_kernels,
and only there, a CUDA tensor takes the plain version too (counted by that
context, _build.takes_plain).  moe.py's grouped products are torch ops
(torch._grouped_mm), as the JAX package leaves its ragged_dot to XLA.

| kernel     | wrapper                                      | replaces (Pallas)                     |
|------------|----------------------------------------------|---------------------------------------|
| K1         | flash_attention.flash_attention              | ops/flash_attention.py:452            |
| K1-bwd dq  | flash_attention.flash_attention_bwd_dq       | ops/flash_attention.py:338 (call 368) |
| K1-bwd dkv | flash_attention.flash_attention_bwd_dkv      | ops/flash_attention.py:338 (call 413) |
| K2         | flash_decode.flash_decode_attention          | ops/flash_decode.py:215               |
| K2-int8    | flash_decode.flash_decode_attention_int8     | ops/flash_decode.py:215 (quant=True)  |
| K3         | vit_window_attention.window_attention_hsd    | ops/vit_window_attention.py:116       |
| K4         | vit_window_attention.chunk_attention_hsd     | ops/vit_window_attention.py:187       |
| K5         | flash_decode.flash_ragged_decode_attention   | ops/flash_decode.py:398               |
| K5-int8    | flash_decode.flash_ragged_decode_attention_int8 | ops/flash_decode.py:398 (quant=True) |
| K6         | int4_matmul.int4_matmul, int4_matmul.dense_q4_fused (quant.dense_q4) | ops/int4_matmul.py:112 |

K2 and K5 take the int8 caches' scales and hand such calls to their int8
wrappers, so each kernel keeps its own count.  K1-bwd's entries from given
statistics (`flash_attention_bwd_dq_from_stats` / `_dkv_from_stats`, ring
attention's: ring_attention.py) launch the same two kernels and count
under theirs.  K6's two entry points (the
scale-free product and dense_q4 with its scales, cast and bias) launch one
kernel and count under `int4_matmul.launches`.  K1 and K1-bwd also count
their launches per head_dim: `launch_counts` reports the instantiations
that the Qwen ViTs' ring (head_dim 80) and Aria's tower backward (72) run
as HEAD_DIM_IDS, whose launches are also in their kernel's total.
"""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """{kernel id: wrapper} for every ported kernel."""
    from spacer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from spacer_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_int8,
        flash_ragged_decode_attention,
        flash_ragged_decode_attention_int8,
    )
    from spacer_tpu_torch.ops.int4_matmul import int4_matmul
    from spacer_tpu_torch.ops.vit_window_attention import (
        chunk_attention_hsd,
        window_attention_hsd,
    )

    return {
        "K1": flash_attention,
        "K1-bwd dq": flash_attention_bwd_dq,
        "K1-bwd dkv": flash_attention_bwd_dkv,
        "K2": flash_decode_attention,
        "K2-int8": flash_decode_attention_int8,
        "K3": window_attention_hsd,
        "K4": chunk_attention_hsd,
        "K5": flash_ragged_decode_attention,
        "K5-int8": flash_ragged_decode_attention_int8,
        "K6": int4_matmul,
    }


# {id: (kernel id, head_dim)}: K1 / K1-bwd instantiations counted apart
HEAD_DIM_IDS = {"K1 d80": ("K1", 80), "K1-bwd dq d80": ("K1-bwd dq", 80),
                "K1-bwd dkv d80": ("K1-bwd dkv", 80),
                "K1-bwd dq d72": ("K1-bwd dq", 72),
                "K1-bwd dkv d72": ("K1-bwd dkv", 72)}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "by_head_dim"):
            fn.by_head_dim.clear()


def launch_counts() -> dict:
    wrappers = kernel_wrappers()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    counts.update({k: wrappers[kernel].by_head_dim[d]
                   for k, (kernel, d) in HEAD_DIM_IDS.items()})
    return counts
