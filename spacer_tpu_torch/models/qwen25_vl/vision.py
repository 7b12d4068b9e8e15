"""Qwen2.5-VL and Qwen2-VL vision transformers in PyTorch (counterpart of
spacer_tpu/models/qwen25_vl/vision.py): windowed or full attention, 2x2
patch merger.

`vision_layout` (the window permutation, padded-window gather/scatter and
rotary positions per grid) is host numpy, copied verbatim from
spacer_tpu/models/qwen25_vl/vision.py:41-173.  `vit_forward` converts the
tokens once to the padded-window layout (uniform windows of wt = 64 tokens)
and runs every block at S_pad: the windowed blocks through K3
(ops/vit_window_attention.window_attention_hsd), the full-attention blocks
through K4 (chunk_attention_hsd) over the compact frame-chunk order, one
call per grid when the grids' frame chunks differ (`chunk_runs`: each
grid's tokens are contiguous in window order, since windows never cross a
grid).
Qwen2-VL (`arch="qwen2"`: every block full attention, LayerNorm with bias,
fc1 -> quick_gelu -> fc2) stays in the native token order with no window
conversion, and every block's frame-chunk attention is K4 over that order
(frame chunks occupy the same token ranges in native and window order).
head_dim 80 stays unpadded.  Both kernels are differentiable (their backward
recomputes through the plain version), and `remat=True` recomputes each
block in the backward pass (torch.utils.checkpoint), as JAX's
jax.checkpoint of the block does.

Ring attention (`attn_impl=("ring", mesh, axis)`, ops/ring_attention.py):
where JAX's attn_impl reaches dot_product_attention, the full-attention
blocks (every block of the Qwen2-VL ViT) attend over equal frame chunks
(`layout.full_chunk > 0`) through the ring instead of K4: the chunks are
the batch, the chunk's tokens the sequence split over the axis, no causal
mask, K1 / K1-bwd at head_dim 80 per block.  Chunks of unequal size keep
K4 (JAX keeps XLA there), windowed blocks keep K3, and a chunk the axis
does not divide raises ValueError.

Tensor parallelism (parallel/tp.py): each rank attends over its heads
(num_heads // tp) through K3 and K4; the fused qkv is column-parallel
head-aware (its q, k and v columns each cut per head), the MLP's gate/up or
fc1 and the merger's mlp_0 column-parallel, proj, down or fc2 and mlp_2
row-parallel with their all-reduce.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from spacer_tpu_torch.models.qwen25_vl.config import VisionConfig
from spacer_tpu_torch.nn.core import (
    dense,
    dense_init,
    layer_norm,
    layer_norm_init,
    quick_gelu,
    rms_norm,
    rms_norm_init,
)
from spacer_tpu_torch.nn.attention import ring_impl
from spacer_tpu_torch.nn.rope import apply_vision_rope, vision_rope_cos_sin
from spacer_tpu_torch.ops.vit_window_attention import (
    chunk_attention_hsd,
    validity_bias,
    window_attention_hsd,
)
from spacer_tpu_torch.parallel import tp
from spacer_tpu_torch.parallel.fsdp import gather
from spacer_tpu_torch.utils import profiling

Params = Any


class VisionLayout(NamedTuple):
    """Host-precomputed gather/mask bookkeeping for one grid_thw batch."""

    window_index: np.ndarray      # (S/mu,) merge-unit permutation to window order
    reverse_index: np.ndarray     # (S_merged,) inverse permutation (merged tokens)
    pos_hw: np.ndarray            # (S, 2) patch (h, w) positions, window order
    pos_hw_native: np.ndarray     # (S, 2) positions in the native token order
    window_segments: np.ndarray   # (S,) segment id per token, window order
    full_segments: np.ndarray     # (S,) frame-chunk segment id, window order
    seq_len: int
    # padded-window fast path: each token belongs to exactly one window of at
    # most `win_tokens` tokens; attention inside windows is dense + masked.
    win_gather: np.ndarray        # (n_win, win_tokens) token idx (window order)
    win_valid: np.ndarray         # (n_win, win_tokens) bool
    win_scatter: np.ndarray       # (S,) index into flattened (n_win*win_tokens)
    # uniform frame-chunk fast path for full-attention layers (or 0 if the
    # chunks are ragged and the segment-mask path must be used)
    full_chunk: int


@functools.lru_cache(maxsize=256)
def _vision_layout_cached(grid_thw: tuple, spatial_merge_size: int,
                          patch_size: int, window_size: int) -> VisionLayout:
    m = spatial_merge_size
    mu = m * m
    vws = window_size // m // patch_size  # window edge in merge units

    window_index_parts = []
    pos_parts = []
    win_seg_parts = []
    full_seg_parts = []
    unit_base = 0      # running merge-unit offset
    win_base = 0       # running window id
    frame_base = 0     # running frame-chunk id

    for (t, h, w) in grid_thw:
        lh, lw = h // m, w // m
        # --- window permutation over merge units (get_window_index parity)
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = vws - lh % vws
        pad_w = vws - lw % vws
        nwh = (lh + pad_h) // vws
        nww = (lw + pad_w) // vws
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, dtype=np.int64)
        padded[:, :lh, :lw] = index
        padded = padded.reshape(t, nwh, vws, nww, vws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nwh * nww, vws, vws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)  # per window
        flat = padded.reshape(-1)
        index_new = flat[flat != -100]
        window_index_parts.append(index_new + unit_base)

        # --- window segment ids (token granularity, window order)
        nonzero = seqlens[seqlens > 0]
        win_ids = np.repeat(np.arange(len(seqlens)) + win_base, seqlens * mu)
        win_seg_parts.append(win_ids)
        win_base += len(seqlens)

        # --- full-attention segment ids: one segment per temporal chunk.
        # Window order only permutes within a t-chunk, so chunk membership is
        # preserved: t-th chunk = lh*lw merge units = lh*lw*mu tokens.
        full_ids = np.repeat(np.arange(t) + frame_base, lh * lw * mu)
        full_seg_parts.append(full_ids)
        frame_base += t

        # --- rotary (h, w) positions per token in merge-unit order
        hpos = np.arange(h)[:, None] * np.ones((1, w), np.int64)
        wpos = np.ones((h, 1), np.int64) * np.arange(w)[None, :]

        def to_unit_order(x):
            x = x.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3)
            return x.reshape(-1)

        ph = np.tile(to_unit_order(hpos), t)
        pw = np.tile(to_unit_order(wpos), t)
        pos = np.stack([ph, pw], axis=-1)  # (t*h*w, 2) merge-unit order
        pos_parts.append(pos)
        unit_base += t * lh * lw

    window_index = np.concatenate(window_index_parts)
    pos = np.concatenate(pos_parts, axis=0)
    # reorder rotary positions into window order (token granularity)
    pos_units = pos.reshape(-1, mu, 2)[window_index]
    pos_hw = pos_units.reshape(-1, 2)
    window_segments = np.concatenate(win_seg_parts)
    full_segments = np.concatenate(full_seg_parts)
    reverse_index = np.argsort(window_index)
    S = int(pos_hw.shape[0])

    # --- padded-window gather/scatter (tokens are contiguous per window in
    # window order, so each window is a [start, start+len) slice)
    win_tokens = vws * vws * mu
    # window id per token is non-decreasing; compute starts/lengths
    _, starts, lengths = np.unique(
        window_segments, return_index=True, return_counts=True
    )
    n_win = len(starts)
    slot = np.arange(win_tokens)
    win_gather = starts[:, None] + np.minimum(slot[None, :],
                                              lengths[:, None] - 1)
    win_valid = slot[None, :] < lengths[:, None]
    # each token's (window, slot) in the flattened padded layout
    win_scatter = np.empty(S, np.int64)
    for w in range(n_win):
        win_scatter[starts[w] : starts[w] + lengths[w]] = (
            w * win_tokens + np.arange(lengths[w])
        )

    # --- uniform frame-chunk size for full-attention layers
    _, chunk_counts = np.unique(full_segments, return_counts=True)
    full_chunk = int(chunk_counts[0]) if len(set(chunk_counts)) == 1 else 0

    return VisionLayout(
        window_index=window_index,
        reverse_index=reverse_index,
        pos_hw=pos_hw,
        pos_hw_native=pos,
        window_segments=window_segments,
        full_segments=full_segments,
        seq_len=S,
        win_gather=win_gather,
        win_valid=win_valid,
        win_scatter=win_scatter,
        full_chunk=full_chunk,
    )


def chunk_runs(layout: VisionLayout) -> list:
    """[(first token, tokens, chunk tokens)] of the maximal runs of
    consecutive frame chunks of one size, in window order: each run is one
    K4 call.  A grid's chunks are uniform and its tokens contiguous (the
    window order permutes within a frame chunk only), so grids whose chunks
    differ split into separate runs."""
    if layout.full_chunk:
        return [(0, layout.seq_len, layout.full_chunk)]
    _, sizes = np.unique(layout.full_segments, return_counts=True)
    runs, start = [], 0
    for size in sizes.tolist():
        if runs and runs[-1][2] == size:
            runs[-1][1] += size
        else:
            runs.append([start, size, size])
        start += size
    return [tuple(r) for r in runs]


def vision_layout(grid_thw, cfg: VisionConfig) -> VisionLayout:
    """grid_thw: iterable of (t, h, w) per image/video (patch units)."""
    key = tuple(tuple(int(v) for v in g) for g in grid_thw)
    return _vision_layout_cached(
        key, cfg.spatial_merge_size, cfg.patch_size, cfg.window_size
    )


def init_vit_params(cfg: VisionConfig, *, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> Params:
    """Random ViT params with spacer_tpu's init scales: Qwen2.5-VL's
    (RMSNorm, SwiGLU) or, with arch "qwen2", Qwen2-VL's (LayerNorm with
    bias, fc1 / fc2)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    merged = D * cfg.spatial_merge_unit
    kw = dict(generator=generator, dtype=dtype, device=device)
    qwen2 = cfg.arch == "qwen2"
    norm_init = layer_norm_init if qwen2 else rms_norm_init

    def block():
        if qwen2:
            mlp = {"fc1": dense_init(D, I, True, **kw),
                   "fc2": dense_init(I, D, True, **kw)}
        else:
            mlp = {"gate_proj": dense_init(D, I, True, **kw),
                   "up_proj": dense_init(D, I, True, **kw),
                   "down_proj": dense_init(I, D, True, **kw)}
        return {
            "norm1": norm_init(D, dtype, device),
            "norm2": norm_init(D, dtype, device),
            "attn": {"qkv": dense_init(D, 3 * D, True, **kw),
                     "proj": dense_init(D, D, True, **kw)},
            "mlp": mlp,
        }

    return {
        "patch_embed": {"proj": dense_init(cfg.patch_dim, D, False, **kw)},
        "blocks": [block() for _ in range(cfg.depth)],
        "merger": {
            "ln_q": norm_init(D, dtype, device),
            "mlp_0": dense_init(merged, merged, True, **kw),
            "mlp_2": dense_init(merged, cfg.out_hidden_size, True, **kw),
        },
    }


def _vit_norm(cfg: VisionConfig, params, x):
    if cfg.arch == "qwen2":
        return layer_norm(params, x, 1e-6)
    return rms_norm(params, x, 1e-6)


def _vit_mlp(cfg: VisionConfig, mlp, x):
    I = cfg.intermediate_size
    x = tp.copy_to_tp(x)
    if cfg.arch == "qwen2":
        return tp.row(mlp["fc2"], quick_gelu(tp.column(mlp["fc1"], x, I)), I)
    return tp.row(mlp["down_proj"],
                  F.silu(tp.column(mlp["gate_proj"], x, I))
                  * tp.column(mlp["up_proj"], x, I), I)


def _merge(params, cfg: VisionConfig, h):
    """The merger: norm -> group spatial_merge_unit tokens -> linear, exact
    gelu, linear."""
    mu = cfg.spatial_merge_unit
    m = params["merger"]
    merged = mu * cfg.hidden_size
    x = _vit_norm(cfg, m["ln_q"], h).reshape(h.shape[0] // mu, merged)
    x = tp.copy_to_tp(x)
    return tp.row(m["mlp_2"], F.gelu(tp.column(m["mlp_0"], x, merged)),
                  merged)


def _qkv(cfg: VisionConfig, attn, x):
    """(S, 3, local heads, Dh): the fused qkv, column-parallel per head."""
    D, Dh = cfg.hidden_size, cfg.head_dim
    qkv = tp.column(attn["qkv"], tp.copy_to_tp(x), 3 * D, pre=3, post=Dh)
    return qkv.reshape(x.shape[0], 3, -1, Dh)


def _proj(cfg: VisionConfig, attn, out):
    """The row-parallel output projection of (S, local heads, Dh)."""
    return tp.row(attn["proj"], out.reshape(out.shape[0], -1),
                  cfg.hidden_size)


def _run_blocks(params, h, block, remat: bool):
    """block(h, bp, li) over every ViT block; remat recomputes each block
    in the backward pass."""
    remat = remat and torch.is_grad_enabled()

    def gathered_block(h, bp, li):
        # fsdp Shards gathered inside the (checkpointed) block
        return block(h, gather(bp), li)

    for li, bp in enumerate(params["blocks"]):
        if remat:
            h = checkpoint(gathered_block, h, bp, li, use_reentrant=False)
        else:
            h = gathered_block(h, bp, li)
    return h


def _ring(attn_impl, layout: VisionLayout):
    """fn(q, k, v) of (S, H, Dh) tokens in compact frame-chunk order ->
    (S, H, Dh): ring attention over each equal frame chunk, the chunks as
    the batch; None where the full-attention blocks keep K4 (no ring, or
    chunks of unequal size)."""
    ring = ring_impl(attn_impl)
    if ring is None or layout.full_chunk == 0:
        return None
    from spacer_tpu_torch.ops.ring_attention import make_ring_attention

    fn = make_ring_attention(*ring, causal=False)
    c = layout.full_chunk

    def attend(q, k, v):
        S, H, Dh = q.shape
        out = fn(*(t.reshape(S // c, c, H, Dh) for t in (q, k, v)))
        return out.reshape(S, H, Dh)

    return attend


def _vit_forward_full(params: Params, cfg: VisionConfig, pixel_values,
                      layout: VisionLayout, remat: bool, attn_impl=None):
    """Qwen2-VL: every block attends within its frame chunks, in the native
    token order (JAX's all-full path): K4 once per run of equal chunks
    (chunk_runs), the run's tokens being one contiguous range, or the ring
    (`_ring`)."""
    Dh = cfg.head_dim
    h = dense(params["patch_embed"]["proj"], pixel_values)  # (S, D)
    profiling.count("host_syncs")
    pos = torch.as_tensor(layout.pos_hw_native, dtype=torch.long,
                          device=h.device)
    cos, sin = vision_rope_cos_sin(pos, Dh, cfg.rope_theta)
    scale = Dh ** -0.5
    runs = chunk_runs(layout)
    ring = _ring(attn_impl, layout)

    def block(h, bp, li):
        x = _vit_norm(cfg, bp["norm1"], h)
        qkv = _qkv(cfg, bp["attn"], x)
        q, k = apply_vision_rope(qkv[:, 0], qkv[:, 1], cos, sin)
        if ring is not None:
            attn = ring(q, k, qkv[:, 2])
        else:
            parts = [chunk_attention_hsd(
                *(t[a:a + n].transpose(0, 1).contiguous()
                  for t in (q, k, qkv[:, 2])), c, scale)
                for a, n, c in runs]
            attn = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            attn = attn.transpose(0, 1)
        h = h + _proj(cfg, bp["attn"], attn)
        return h + _vit_mlp(cfg, bp["mlp"], _vit_norm(cfg, bp["norm2"], h))

    return _merge(params, cfg, _run_blocks(params, h, block, remat))


def vit_forward(params: Params, cfg: VisionConfig, pixel_values,
                layout: VisionLayout, remat: bool = False, attn_impl=None):
    """pixel_values (S, patch_dim) -> merged embeddings (S / mu, out_hidden)
    in the original (pre-window-permutation) token order.  attn_impl: None
    or ("ring", mesh, axis) (the module docstring)."""
    ring_impl(attn_impl)
    params = gather(params, keep=("blocks",))
    if len(set(cfg.fullatt_block_indexes)) == cfg.depth:
        return _vit_forward_full(params, cfg, pixel_values, layout, remat,
                                 attn_impl)
    dev = pixel_values.device
    mu = cfg.spatial_merge_unit
    Dh = cfg.head_dim
    h = dense(params["patch_embed"]["proj"], pixel_values)  # (S, D)
    S = h.shape[0]

    def idx(a):
        profiling.count("host_syncs")   # a pageable host-to-device copy
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

    h = h.reshape(S // mu, mu, -1)[idx(layout.window_index)].reshape(S, -1)
    wt = layout.win_gather.shape[1]
    pad_gather = idx(layout.win_gather.reshape(-1))   # (S_pad,) -> window order
    to_compact = idx(layout.win_scatter)               # (S,) -> padded index
    h = h[pad_gather]  # pad slots replicate a token of their window
    cos, sin = vision_rope_cos_sin(
        idx(layout.pos_hw[layout.win_gather.reshape(-1)]), Dh, cfg.rope_theta)
    profiling.count("host_syncs")
    bias = torch.from_numpy(
        validity_bias(layout.win_valid.sum(axis=1), wt)).to(dev)
    scale = Dh ** -0.5
    full_set = set(cfg.fullatt_block_indexes)
    runs = chunk_runs(layout)
    ring = _ring(attn_impl, layout)

    def block(h, bp, li):
        x = _vit_norm(cfg, bp["norm1"], h)
        qkv = _qkv(cfg, bp["attn"], x)
        q, k = apply_vision_rope(qkv[:, 0], qkv[:, 1], cos, sin)
        v = qkv[:, 2]
        if li in full_set and ring is not None:
            # the compact frame-chunk order, the ring, back to the windows
            attn = ring(*(t[to_compact] for t in (q, k, v)))[pad_gather]
        elif li in full_set:
            # frame chunks are contiguous in the compact window order; with
            # grids whose chunks differ, one K4 call per grid over the
            # grid's own token range (JAX masks segments over the whole
            # sequence: the same attention)
            q, k, v = (t.transpose(0, 1) for t in (q, k, v))  # (H, S_pad, Dh)
            parts = [chunk_attention_hsd(
                *(t[:, to_compact[a:a + n]] for t in (q, k, v)), c, scale)
                for a, n, c in runs]
            attn = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            attn = attn[:, pad_gather].transpose(0, 1)
        else:
            q, k, v = (t.transpose(0, 1).contiguous() for t in (q, k, v))
            attn = window_attention_hsd(q, k, v, bias, wt, scale).transpose(0, 1)
        h = h + _proj(cfg, bp["attn"], attn)
        return h + _vit_mlp(cfg, bp["mlp"], _vit_norm(cfg, bp["norm2"], h))

    h = _run_blocks(params, h, block, remat)
    h = h[to_compact]  # back to the compact window order
    return _merge(params, cfg, h)[idx(layout.reverse_index)]
