"""Plain float32 building blocks of the references (no kernel, no cache, no
batching).  They import nothing of the program: the parameter tree they read
is the one the benchmark made (harness/weights.py) and handed to both sides.

`Precision` says how a product is computed: exact float32 (TF32 off), or,
for the control, with both operands rounded to float8 e4m3 (per row of the
activations and per output column of the weights, scaled to the format's
range) before a float32 product: the step below the bfloat16 that the
configurations state.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn
ATTN_BLOCK = 512         # query rows per attention block (bounds memory)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference computes its products: "f32" or "fp8" (control)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (in, out) or (E, in, out) weight in float32 as this precision
        holds it."""
        w = w.float()
        return fp8_round(w, dim=-2) if self.kind == "fp8" else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_round(x, dim=-1) if self.kind == "fp8" else x

    def linear(self, x, w, b=None):
        """x (..., in) @ w (in, out) [+ b]; w already through `weight`."""
        y = self.act(x) @ w
        return y + b.float() if b is not None else y


def rms_norm(x, scale, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def rope(x, cos, sin):
    """x (S, H, D); cos, sin (S, D)."""
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    """(dim / 2,) inverse frequencies of a rotary embedding over `dim`."""
    return 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                        device=device).float() / dim)


def causal_attention(q, k, v):
    """q (S, H, D), k / v (S, Hkv, D), causal, one sequence, no padding."""
    S, H, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # (H, S, D)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D)
    for a in range(0, S, ATTN_BLOCK):
        b = min(S, a + ATTN_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * scale
        rows = torch.arange(a, b, device=q.device)[:, None]
        cols = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1), v[:, :b])
    return out


def segment_attention(q, k, v, lengths):
    """Non-causal attention within consecutive segments of the given
    lengths: q, k, v (S, H, D).  Segments of one length run as a batch."""
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    starts, pos = [], 0
    for n in lengths:
        starts.append(pos)
        pos += n
    by_len: dict[int, list[int]] = {}
    for s0, n in zip(starts, lengths):
        if n:
            by_len.setdefault(n, []).append(s0)
    for n, s0s in by_len.items():
        idx = (torch.tensor(s0s, device=q.device)[:, None]
               + torch.arange(n, device=q.device)[None, :])      # (W, n)
        for c in range(0, len(s0s), 64):
            rows = idx[c:c + 64]
            qs, ks, vs = q[rows], k[rows], v[rows]               # (w, n, H, D)
            s = torch.einsum("wqhd,wkhd->whqk", qs, ks) * scale
            out[rows] = torch.einsum("whqk,wkhd->wqhd", torch.softmax(s, -1), vs)
    return out


def gaps(logits, tokens):
    """(n, V) reference logits and the n tokens served there -> (n,) how far
    each token's logit lies below the best one."""
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]
