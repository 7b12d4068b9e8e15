"""K3 and K4: segment attention for the Qwen2.5-VL ViT on Hopper.

- K3 `window_attention_hsd` (csrc/vit_window_attention.cu) replaces
  spacer_tpu/ops/vit_window_attention.py::window_attention_hsd (`_kernel`):
  attention inside uniform windows of `wt` <= 64 tokens with a ragged
  validity bias (the 28 windowed layers, wt = 64).  A window is one 64-row
  q tile and one key tile, so one CTA of one warpgroup per (window, head)
  TMA-loads Q, K, V once (maps bounded by the window), takes S = Q K^T and
  P V on wgmma with an exact softmax in registers, and several such CTAs
  share an SM to overlap loads and products; the TPU kernel's 8x
  block-diagonal matmul is not needed.  At the ViT's shape (16, 4096, 80)
  its bound is the bytes of q, k, v and out (42 MB).  Larger windows raise
  ValueError (no model config of the repo has one).
- K4 `chunk_attention_hsd` (csrc/vit_chunk_attention.cu) replaces
  ::chunk_attention_hsd (`_kernel_nomask`): dense attention inside each
  temporal frame chunk of `wt` tokens (the 4 full-attention layers).  One
  CTA per 256-query tile of a chunk streams the chunk's keys through a TMA
  ring into wgmma products with the online softmax and the output in
  registers; TMA maps bounded by the chunk zero-fill the tiles that run past
  its end.  At the ViT's shape (16, 3840, 80), wt = 480, its bound is the
  bytes of q, k, v and out (39 MB) just above the products (9.44 GFLOP).

Layout (H, S, D) as in JAX, with the ViT's head_dim 80 unpadded.

`window_attention` / `make_window_attention` are JAX's packed-layout entry
over K3: q, k, v (S_pad, H, D) in uniform-window order with per-window
valid counts are put head-major (a head dim under 80 zero-padded to K3's
80, which changes no logit and no kept output column) and go through
`window_attention_hsd`, the validity bias built once per bound layout and
device; autograd carries the layout, and K3's backward recomputes through
the plain version, as JAX's custom VJP does.

On a CUDA tensor each wrapper is a torch.autograd.Function whose backward
recomputes through the plain version, exactly as the JAX VJPs
(`_wa_hsd_bwd`, `_ca_hsd_bwd`) recompute through `_xla_reference_hsd`: the
TPU package has no backward kernel here, so the port adds none.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its own launches (`.launches`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spacer_tpu_torch.ops import _build

MASK_VALUE = -1e30
HEAD_DIMS = (80,)
WINDOW_MAX = 64   # K3's largest window: one key tile


def validity_bias(lengths, wt: int) -> np.ndarray:
    """(1, n_win*wt) f32 additive bias: 0 on valid slots, -1e30 on the pad
    slots at the end of short windows."""
    valid = np.arange(wt)[None, :] < np.asarray(lengths)[:, None]
    return np.where(valid.reshape(1, -1), 0.0, MASK_VALUE).astype(np.float32)


def window_attention_reference(q, k, v, bias, wt: int, scale: float):
    """Plain version of K3 (and, with a zero bias, K4): per-segment softmax
    attention, f32 logits, probabilities rounded to the value dtype before
    P.V (the TPU reference's rounding points)."""
    H, S, D = q.shape
    n = S // wt
    qr, kr, vr = (x.reshape(H, n, wt, D).float() for x in (q, k, v))
    s = torch.einsum("hnid,hnjd->hnij", qr, kr) * scale
    s = s + bias.reshape(1, n, 1, wt).float()
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("hnij,hnjd->hnid", p, vr)
    return o.reshape(H, S, D).to(q.dtype)


def chunk_attention_reference(q, k, v, wt: int, scale: float):
    """Plain version of K4."""
    bias = torch.zeros((1, q.shape[1]), dtype=torch.float32, device=q.device)
    return window_attention_reference(q, k, v, bias, wt, scale)


def _check(q, k, v, wt):
    """Hopper legality gate of K3/K4 (raises ValueError)."""
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"segment attention kernel takes bf16, got {q.dtype}")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (H, S, D) shape")
    H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if wt <= 0 or S % wt:
        raise ValueError(f"S={S} is not a multiple of the segment size {wt}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _recompute_grads(plain_fn, q, k, v, dout):
    """(dq, dk, dv) by autograd through the plain version."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
        return torch.autograd.grad(plain_fn(qd, kd, vd), (qd, kd, vd), dout)


class _WindowFn(torch.autograd.Function):
    """K3 forward kernel; backward through window_attention_reference."""

    @staticmethod
    def forward(ctx, q, k, v, bias, wt, scale):
        H, S, D = q.shape
        out = torch.empty_like(q)
        p = _build.ptr
        err = _build.kernels().spacer_window_attention_hsd(
            p(q), p(k), p(v), p(bias), p(out), H, S, D, int(wt), float(scale),
            _build.stream_ptr(q.device))
        _build.check(err, "window_attention_hsd")
        window_attention_hsd.launches += 1
        ctx.save_for_backward(q, k, v, bias)
        ctx.wt, ctx.scale = wt, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        grads = _recompute_grads(
            lambda a, b, c: window_attention_reference(a, b, c, bias, ctx.wt,
                                                       ctx.scale),
            q, k, v, dout)
        return (*grads, None, None, None)


class _ChunkFn(torch.autograd.Function):
    """K4 forward kernel; backward through chunk_attention_reference."""

    @staticmethod
    def forward(ctx, q, k, v, wt, scale):
        H, S, D = q.shape
        out = torch.empty_like(q)
        p = _build.ptr
        err = _build.kernels().spacer_chunk_attention_hsd(
            p(q), p(k), p(v), p(out), H, S, D, int(wt), float(scale),
            _build.stream_ptr(q.device))
        _build.check(err, "chunk_attention_hsd")
        chunk_attention_hsd.launches += 1
        ctx.save_for_backward(q, k, v)
        ctx.wt, ctx.scale = wt, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _recompute_grads(
            lambda a, b, c: chunk_attention_reference(a, b, c, ctx.wt, ctx.scale),
            *ctx.saved_tensors, dout)
        return (*grads, None, None)


def window_attention_hsd(q, k, v, bias, wt: int, scale: float):
    """K3.  q, k, v (H, S, D); bias (1, S) f32 from validity_bias()."""
    if _build.takes_plain(q, "K3"):
        return window_attention_reference(q, k, v, bias, wt, scale)
    _check(q, k, v, wt)
    if wt > WINDOW_MAX:
        raise ValueError(f"window of {wt} tokens: K3 takes at most {WINDOW_MAX}")
    S = q.shape[1]
    if (bias.dtype != torch.float32 or bias.numel() != S
            or bias.device != q.device):
        raise ValueError("bias must be a (1, S) f32 tensor on q's device")
    return _WindowFn.apply(q, k, v, bias.contiguous(), wt, scale)


def chunk_attention_hsd(q, k, v, wt: int, scale: float):
    """K4.  q, k, v (H, S, D), S = n_chunks * wt, every slot valid."""
    if _build.takes_plain(q, "K4"):
        return chunk_attention_reference(q, k, v, wt, scale)
    _check(q, k, v, wt)
    return _ChunkFn.apply(q, k, v, wt, scale)


def _pad_head(x, dp: int):
    """(S_pad, H, D) -> (H, S_pad, dp) contiguous, columns D..dp-1 zero."""
    x = x.transpose(0, 1)
    if x.shape[-1] != dp:
        x = torch.nn.functional.pad(x, (0, dp - x.shape[-1]))
    return x.contiguous()


@functools.lru_cache(maxsize=256)
def make_window_attention(lengths: tuple, wt: int, scale: float):
    """attn(q, k, v) -> out for a fixed window layout (window_attention's
    arguments bound); the validity bias is built once per device."""
    bias_np = validity_bias(lengths, wt)
    biases = {}

    def attn(q, k, v):
        D = q.shape[-1]
        dp = next((d for d in HEAD_DIMS if d >= D), D)
        bias = biases.get(q.device)
        if bias is None:
            bias = biases[q.device] = torch.from_numpy(bias_np).to(q.device)
        out = window_attention_hsd(_pad_head(q, dp), _pad_head(k, dp),
                                   _pad_head(v, dp), bias, wt, scale)
        return out[..., :D].transpose(0, 1)

    return attn


def window_attention(q, k, v, lengths, *, wt: int, scale=None):
    """Uniform-window attention: q, k, v (S_pad, H, D) in packed window
    order (window i holds slots [i * wt, (i + 1) * wt), its first
    lengths[i] valid), each slot attending the valid slots of its window.
    Differentiable: the layout by autograd, K3's backward through its plain
    version.  A CPU tensor takes the plain version, a CUDA tensor launches
    K3 or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return make_window_attention(tuple(int(x) for x in lengths), int(wt),
                                 float(scale))(q, k, v)


window_attention_hsd.launches = 0
chunk_attention_hsd.launches = 0
