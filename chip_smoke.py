"""Smoke test of spacer_tpu_torch on one NVIDIA Hopper GPU (H100).

Phases, in order; any failure raises and the script exits non-zero:
  1. device facts (CUDA device of capability 9.0 required; no CPU path);
  2. build the CUDA kernels from spacer_tpu_torch/csrc with nvcc (one nvcc
     per source, all at once);
  3. each kernel against its plain PyTorch version on the card, with max
     abs error, median time, the card's least time for the same work
     (roofline) and, where one PyTorch call computes the same function, that
     call's time: K1, K3, K4, K5, K5-int8 at the serving path's shapes (K4
     also at chunks of 252 tokens, no multiple of its tiles; K5 and K5-int8
     also at the serving batcher's 4 slots and Cmax 64); K6 at every (K, N)
     of the 7B int4 decode with M = 4 and 16, as the scale-free product and
     as the fused dense_q4 (row scale, cast, bias), with torch's
     _weight_int4pack_mm as its yardstick; K1, K1-bwd (dq, dk/dv), K2 and
     K2-int8 at the training path's shapes (prompt bucket
     TRAIN_PROMPT_BUCKET, left padding TRAIN_PROMPT_PAD, which phase 5 checks
     its batches against), at a two-prompt batch and, K2 / K2-int8, at
     K2_WIDE_G completions per prompt and at the eval's one completion per
     prompt (EVAL_PROMPT_BUCKET, EVAL_PROMPT_PADS, which phase 7 checks its
     prompts against); the int8
     weight-only decode products (dense_q8, no kernel of its own) against
     the bf16 products they replace.  Every kernel and library call also
     gets a device-only time per call from torch.profiler (the sum of the
     call's kernels, without the wrapper's host time);
  4. the serving slice end to end at the full Qwen2.5-VL-7B geometry
     (random bf16 weights from a seed): 2 video + 2 text requests through
     QwenEngine.generate_many, greedy; every request must emit a token, all
     logits must be finite and every kernel of the path must have been
     launched; then the same requests with plain attention and the first
     run's tokens replayed, whose logits must agree with the kernel run's
     (rows of slots with a live key);
  4b. the same with decode_quant="int4_kv" (K6 weight products, K5-int8
     attention), replayed through the plain versions likewise; token
     agreement with phase 4 is printed, not gated;
  5. the SG-RLVR training slice at Qwen2.5-VL-7B widths with the LM cut to
     TRAIN_LM_LAYERS layers: two optimizer steps of SGRLVRTrainer.train at
     the trainer's default decode_quant="int8_kv" on a 16-frame video row
     (merged temporal rollout through K2-int8, rewards, reference logps,
     shared-prefix forward/backward through K1, K1-bwd, K3, K4, int8-moment
     AdamW); every K2-int8 call of every K2_CHECK_EVERY-th rollout step held
     against its plain version on its live inputs; finite loss/kl/grad_norm,
     a nonzero gradient for every trainable tensor, per-group gradient
     cosine against a plain-attention replay of the first update (which
     must launch no kernel), moved int8 moments, and every kernel of the
     path launched;
  5b. one bf16 rollout (decode_quant=None) of phase 5's first batch with
     the trained params, its K2 calls held against the plain version live;
  6. a checkpoint at Qwen2.5-VL-7B widths (LM cut to CKPT_LM_LAYERS layers,
     full vocab, all 32 ViT blocks) written by export_to_safetensors in HF's
     sharded layout and loaded back onto the card by load_params_from_hf:
     every tensor bitwise equal; write / load GB/s and the host's peak RSS
     growth logged;
  7. the eval path (cli/evaluate.py's run_benchmark -> QwenEngine) at full
     Qwen2.5-VL-7B geometry on 4 LongVideoBench rows over 2 synthetic
     360x640 videos, 32 frames each, once serving="static" (K1, K3, K4, K2
     at G = 1, its K2 calls held against the plain version live) and once
     serving="continuous" (K1, K3, K4, K5); the engine's exceptions, which
     the harness turns into empty answers, are recorded and fail the phase.
The line before the last is a JSON object describing the kernels (launches
summed over the paths of phases 4-5b and 7, each counted from 0 just before
it runs); the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version, bf16 outputs of O(1) magnitude: |out - ref| <=
# BF16_TOL * (1 + |ref|).  bf16 keeps 8 significant bits (a relative step of
# 2^-8 = 3.9e-3), and the kernel rounds the softmax probabilities to bf16
# before P.V where the plain version keeps f32 until the output, so elements
# differ by about one bf16 step of their magnitude; 2e-2 bounds that with
# margin while still catching a wrong mask, index or scale (errors of
# O(0.1-1)).
BF16_TOL = 2e-2
# The slice, kernel path vs plain-attention path on identical tokens: every
# row of every sampled step's logits must have cosine similarity >= this.
# 28 bf16 decoder layers on random weights amplify the per-kernel
# differences above; a wrong mask or index drops the cosine far lower.
SLICE_COS_TOL = 0.99
# K1 backward vs autograd through the plain attention, per gradient tensor:
# ||kernel - plain|| <= GRAD_REL_TOL * ||plain||.  The kernels round p and ds
# to bf16 before their products (as the TPU kernel does) and write bf16; each
# rounding is 2^-9 relative with random sign, so the norm error is a few
# 1e-3.  A wrong mask, index or scale gives O(1).
GRAD_REL_TOL = 2e-2
# The training slice's first update, kernels vs plain attention on the same
# params and batch: per tensor group, cosine(kernel grads, plain grads) >=
# this.  Both backward passes run 14 bf16 LM layers and 32 ViT blocks; a
# wrong mask, index or dropped gradient gives a far lower cosine (or 0).
GRAD_COS_TOL = 0.99
# LM depth of the training slice: bf16 params, the reference copy, bf16
# grads and int8 moments of 14 of the 28 layers (~5.0 B params) take ~43 GB
# of the card's 80 GB, leaving room for activations; full depth would need
# ~71 GB before any activation.
TRAIN_LM_LAYERS = 14
# The training slice's prompt: 1069 tokens (16-frame 360x640 video, grid
# (8, 16, 30) -> 960 video tokens, plus the chat template and question),
# left-padded to the trainer's 512-token bucket.  Phase 3b holds K1-bwd and
# K2 against their plain versions at these shapes; phase 5 fails if its
# batches have others.
TRAIN_PROMPT_BUCKET = 1536
TRAIN_PROMPT_PAD = 1536 - 1069
# Training slice: completions per prompt and new tokens per completion.
TRAIN_G, TRAIN_NEW_TOKENS = 8, 256
# Phase 5 holds K2 against its plain version on the live inputs of every
# layer at rollout steps 1, 1 + K2_CHECK_EVERY, ...
K2_CHECK_EVERY = 32
TIMED_RUNS = 25
# K6 against its plain version: both sum exact bf16 x int4 products in f32,
# in different orders, so |kernel - plain| <= K6_SUM_TOL * sum |terms| per
# output (2^-24 per addition over K <= 18944 terms, with margin); a wrong
# nibble, pairing or column gives errors of the order of the sum itself.
# The fused dense_q4 (bf16 out) also rounds twice, at the cast and at the
# bias add, where a different summation order can flip a rounding: one bf16
# ulp, <= K6_BF16_ULP of the rounded value, at each.
K6_SUM_TOL = 1e-5
K6_BF16_ULP = 2.0 ** -7
# (K, N) of every int4 decode product at 7B widths: q/o, k/v, gate/up, down,
# lm_head; M = the serving slots (4) and the rollout's B*G rows (16)
K6_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
             (3584, 152064))
K6_PATH_SHAPE = (4, 3584, 18944)   # the kernels line's K6 entry: gate/up
# K2 / K2-int8 also at this many completions per prompt (G * group_q = 112
# query rows: two of the prefix jobs' 64-row tiles)
K2_WIDE_G = 16
# Phase 6: the checkpoint at Qwen2.5-VL-7B widths, the LM cut to this many
# layers (full vocab, all 32 ViT blocks: every kind of tensor, 2.23 B
# params, ~4.5 GB in bf16), written in HF's sharded layout with shards of at
# most CKPT_SHARD_BYTES.
CKPT_LM_LAYERS = 2
CKPT_SHARD_BYTES = 2 * 2 ** 30
# Phase 7, the eval path: LongVideoBench rows over 360x640 videos of
# EVAL_VIDEO_SECONDS, 32 frames at fps 1.  The frame loader turns each frame
# portrait, 251 wide and 448 high (the reference's aspect transposition),
# so the video grid is EVAL_GRID and every prompt buckets to
# EVAL_PROMPT_BUCKET; the first static batch's two prompts are left-padded
# by EVAL_PROMPT_PADS.  Phase 3 holds K2 at G = 1 at these shapes; phase 7
# fails if its prompts have others.  (Worked out on the CPU: the processor
# is deterministic.)
EVAL_VIDEO_SECONDS, EVAL_VIDEO_FPS = 34, 4
EVAL_GRID = (16, 32, 18)
EVAL_PROMPT_BUCKET = 2560
EVAL_PROMPT_PADS = (130, 126)
EVAL_NEW_TOKENS = 64
LVB_METRICS = {"overall_accuracy", "all_duration_tasks",
               "perception_task_accuracy", "relation_task_accuracy"}
# The card's peaks for the roofline bound (NVIDIA's H100 SXM data sheet, at
# its 700 W limit): HBM bytes per second and dense bf16 tensor-core
# operations per second.  Every kernel here multiplies bf16 operands (int8
# and int4 codes are widened to bf16 first).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_facts():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script has no CPU path)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper GPU (sm_90), got {cap}")
    # phase 7 writes its videos with cv2 and the eval harness reads them
    # into PIL frames
    try:
        import cv2
        import PIL
    except ImportError as e:
        raise SystemExit(f"chip_smoke: phase 7 needs cv2 and PIL: {e}") from e
    from spacer_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{[l for l in nvcc.splitlines() if 'release' in l][0].strip()} | "
        f"cv2 {cv2.__version__} | PIL {PIL.__version__}")
    return smi


def build_kernels():
    from spacer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc + load) -> "
        f"{_build.library_path()}")


def median_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, floor_ms: float = 0.0, runs: int = 10, tries: int = 3):
    """Device time per call of `fn`: the durations of the CUDA kernels (and
    copies) it launches, summed over `runs` calls under torch.profiler and
    divided by `runs`.  A reading that lost records is refused and taken
    again, up to `tries` times: one where some kernel name was recorded a
    number of times that is no multiple of `runs`, or whose total is under
    `floor_ms` (the call's roofline bound, which a whole reading cannot
    beat).  None if no try gave a whole reading."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        names, us = collections.Counter(), 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] += 1
                us += e.time_range.elapsed_us()
        ms = us / runs / 1e3
        if names and ms >= floor_ms and all(n % runs == 0
                                            for n in names.values()):
            return ms
        log(f"device_ms: refused a reading of {ms:.4f} ms (floor "
            f"{floor_ms:.4f} ms) over {runs} calls, kernels recorded "
            f"{dict(names)}")
    return None


def roofline(nbytes: float, ops: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes over HBM_BYTES_PER_S and its bf16 operations over BF16_OPS_PER_S,
    and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(name, kernel_fn, plain_fn, select=lambda x: x, rel_norm=False,
            work=None, library_fn=None, allowed=None):
    """Kernel vs plain version on the same inputs.  Elementwise
    |out - ref| <= BF16_TOL * (1 + |ref|), or with `rel_norm` (gradients,
    whose elements sum many bf16-rounded products and cancel)
    ||out - ref|| <= GRAD_REL_TOL * ||ref|| per output tensor, or
    |out - ref| <= `allowed` (a tensor of the output's shape).
    `work` = (bytes, bf16 operations) of the call, which gives its roofline
    bound; `library_fn` one PyTorch call computing the same function, timed
    as a yardstick (the port never calls it).  The kernel's and the library
    call's device-only times (`device_ms`) are reported beside their
    CUDA-event times, which include the host's launch time."""
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
    err, worst, within = 0.0, 0.0, True
    for o, r in zip(out, ref):
        o, r = select(o).float(), select(r).float()
        diff = (o - r).abs()
        err = max(err, float(diff.max()))
        if rel_norm:
            rel = float(diff.norm() / r.norm().clamp_min(1e-30))
            worst = max(worst, rel)
            within &= rel <= GRAD_REL_TOL
        elif allowed is not None:
            within &= bool((diff <= allowed).all())
        else:
            within &= bool((diff <= BF16_TOL * (1 + r.abs())).all())
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    library_ms = median_ms(library_fn) if library_fn is not None else None
    bound = roofline(*work) if work is not None else {}
    floor = bound.get("bound_ms", 0.0)
    dev = {"device_ms": device_ms(kernel_fn, floor)}
    if library_fn is not None:
        dev["library_device_ms"] = device_ms(library_fn, floor)
    tol = (f"rel-norm {worst:.3e} (tol {GRAD_REL_TOL:.0e})" if rel_norm
           else "tol: summation order" if allowed is not None
           else f"tol {BF16_TOL:.0e} * (1 + |ref|)")
    extra = "".join([
        f" | bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
        if bound else "",
        f" | library {library_ms:.4f} ms" if library_ms is not None else "",
        "".join(f" | {k} {v:.4f}" if v is not None else f" | {k} not measured"
                for k, v in dev.items())])
    log(f"{name}: max_abs_err {err:.3e} ({tol}) | kernel {ms:.4f} ms | "
        f"plain {plain_ms:.4f} ms{extra}")
    if not (finite and within):
        raise RuntimeError(f"{name} disagrees with its plain version: "
                           f"err {err} finite {finite}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms, **dev}


def causal_pairs(valid_rows) -> int:
    """(query, key) pairs of a causal self-attention whose rows are
    left-padded: a row with n valid positions has n (n + 1) / 2."""
    return sum(n * (n + 1) // 2 for n in valid_rows)


def sdpa_masked(q, k, v, mask):
    """torch's scaled_dot_product_attention on the port's (B, S, H, D)
    layout with a bool (B, 1, Sq, Skv) mask: the library yardstick."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).transpose(1, 2)


def int8_cache(x, gen):
    """A bf16 cache with per-key magnitudes that differ -> (int8 codes,
    (..., 1, T) f32 scales), as the int8_kv paths hold it."""
    from spacer_tpu_torch.ops.quant import quantize_kv

    mag = torch.rand(x.shape[:-1] + (1,), generator=gen, device=x.device)
    q, s = quantize_kv(x.float() * (0.2 + 2.8 * mag))
    return q, s[:, :, None].contiguous()


def check_kernels(device="cuda") -> dict:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import vit_window_attention as vwa
    from spacer_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    results = {}
    # K1: LM prefill, B=2, P=1024, 28/4 heads, D=128, causal, left-padded
    B, P, H, Hkv, D = 2, 1024, 28, 4, 128
    q, k, v = randn(B, P, H, D), randn(B, P, Hkv, D), randn(B, P, Hkv, D)
    pads = (0, 300)
    mask = torch.ones((B, P), dtype=torch.bool, device=dev)
    for b, p in enumerate(pads):
        mask[b, :p] = False
    valid_rows = torch.cat([torch.arange(p, P, device=dev) + b * P
                            for b, p in enumerate(pads)])

    def rows(x):  # valid query rows of (B,S,H,D) outputs or (B,H,S) LSEs
        if x.dim() == 3:
            x = x.transpose(1, 2)
        return x.reshape(B * P, -1)[valid_rows]

    kw = dict(causal=True, kv_mask=mask, return_lse=True)
    n_valid = [P - p for p in pads]
    k1_bytes = sum(n * (2 * H * D * 2 + 2 * Hkv * D * 2 + H * 4)
                   for n in n_valid)
    causal = torch.ones((P, P), dtype=torch.bool, device=dev).tril()
    sdpa_mask = (causal[None] & mask[:, None, :])[:, None]
    results["K1"] = compare(
        "K1 flash_attention", lambda: flash_attention(q, k, v, **kw),
        lambda: xla_attention(q, k, v, **kw), rows,
        work=(k1_bytes, 4 * D * H * causal_pairs(n_valid)),
        library_fn=lambda: sdpa_masked(q, k, v, sdpa_mask))

    # K5 / K5-int8 at RAGGED_CASES' slot layouts
    for tag, case in RAGGED_CASES.items():
        results.update(check_ragged_decode(randn, gen, tag, P, *case))

    # K3 / K4: ViT at grid (8, 16, 30): 16 heads, head_dim 80
    vcfg = QWEN25_VL_7B.vision
    layout = vision_layout([(8, 16, 30)], vcfg)
    n_win, wt = layout.win_gather.shape
    Hv, Dv = vcfg.num_heads, vcfg.head_dim
    scale = Dv ** -0.5
    qw, kw3, vw = (randn(Hv, n_win * wt, Dv) for _ in range(3))
    lengths = np.asarray(layout.win_valid.sum(1))
    bias = torch.from_numpy(vwa.validity_bias(lengths, wt)).to(dev)
    win_mask = (bias == 0).view(1, n_win, 1, wt)

    def windows(x, n, w):
        return x.view(Hv, n, w, Dv)

    results["K3"] = compare(
        f"K3 window_attention_hsd (16, {n_win * wt}, 80) wt={wt}",
        lambda: vwa.window_attention_hsd(qw, kw3, vw, bias, wt, scale),
        lambda: vwa.window_attention_reference(qw, kw3, vw, bias, wt, scale),
        work=(4 * Hv * int(lengths.sum()) * Dv * 2 + n_win * wt * 4,
              4 * Dv * Hv * int((lengths.astype(np.int64) ** 2).sum())),
        library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(
            *(windows(x, n_win, wt) for x in (qw, kw3, vw)),
            attn_mask=win_mask, scale=scale))
    # K4 at the ViT's chunks (the kernels line) and at 8 chunks of 252 =
    # 18 x 14 patches (a 252x196 frame pair), no multiple of the kernel's
    # 64-key tiles
    for tag, S, chunk in (("K4", layout.seq_len, layout.full_chunk),
                          ("K4 wt=252", 8 * 252, 252)):
        qc, kc, vc = (randn(Hv, S, Dv) for _ in range(3))
        results[tag] = compare(
            f"K4 chunk_attention_hsd (16, {S}, 80) wt={chunk}",
            lambda: vwa.chunk_attention_hsd(qc, kc, vc, chunk, scale),
            lambda: vwa.chunk_attention_reference(qc, kc, vc, chunk, scale),
            work=(4 * Hv * S * Dv * 2, 4 * Dv * Hv * S * chunk),
            library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(
                *(windows(x, S // chunk, chunk) for x in (qc, kc, vc)),
                scale=scale))
    results.update(check_int4_matmul(gen))
    dense_q8_cost(gen)
    return results


# K5 / K5-int8 slot layouts at Pmax 1024, Hkv 4, gq 7: {result tag: (Cmax,
# prefix lengths, ring lengths, ring admit indices)}.  "": R=8 slots of
# every kind, two empty (the kernels line); " R=4 Cmax=64": the serving
# batcher's own geometry, two video slots mid-decode (one ring window
# wrapping past Cmax - 1), two empty.
RAGGED_CASES = {
    "": (128, [1024, 900, 517, 64, 1, 0, 700, 0],
         [128, 5, 77, 1, 0, 0, 64, 0], [0, 120, 60, 9, 0, 0, 100, 0]),
    " R=4 Cmax=64": (64, [993, 988, 0, 0], [40, 50, 0, 0], [0, 30, 0, 0]),
}


def ragged_decode_case(randn, gen, P, C, plen, tlen, admit):
    """K5's inputs on R = len(plen) slot rows: row r's prefix live in its
    last plen[r] of P keys, its ring window the tlen[r] positions from ring
    index admit[r] on (mod C); bf16 caches for K5, int8 codes + f32 scales
    of the same values for K5-int8.  -> ({kernel id: args}, kwargs, live
    rows, {kernel id: (bytes, bf16 operations)})."""
    from spacer_tpu_torch.ops import flash_decode as fd

    dev = gen.device
    R, Hkv, gq, D = len(plen), 4, 7, 128
    qd = randn(R, Hkv, gq, D)
    pk, pv = randn(R, Hkv, P, D), randn(R, Hkv, P, D)
    tk, tv = randn(R, Hkv, C, D), randn(R, Hkv, C, D)
    plen, tlen, admit = (torch.tensor(x, device=dev) for x in (plen, tlen, admit))
    pmask = torch.arange(P, device=dev)[None] >= (P - plen)[:, None]
    rel = torch.remainder(torch.arange(C, device=dev)[None] - admit[:, None], C)
    rmask = rel < tlen[:, None]
    bias_p = torch.where(pmask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    bias_t = torch.where(rmask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    (pk8, pks), (pv8, pvs), (tk8, tks), (tv8, tvs) = (
        int8_cache(x, gen) for x in (pk, pv, tk, tv))
    # work: q, the live keys' K and V (bf16, or int8 codes + f32 scales),
    # both biases, the f32 output
    n_keys = int(pmask.sum() + rmask.sum())
    qo_bytes = R * Hkv * gq * D * (2 + 4) + R * (P + C) * 4
    ops = 4 * D * gq * Hkv * n_keys
    args = {"K5": (qd, pk, pv, bias_p, tk, tv, bias_t),
            "K5-int8": (qd, pk8, pv8, bias_p, tk8, tv8, bias_t, pks, pvs, tks,
                        tvs)}
    work = {"K5": (qo_bytes + n_keys * Hkv * D * 2 * 2, ops),
            "K5-int8": (qo_bytes + n_keys * Hkv * (D + 4) * 2, ops)}
    return (args, dict(group_q=gq, sm_scale=D ** -0.5),
            pmask.any(1) | rmask.any(1), work)


def check_ragged_decode(randn, gen, tag, P, C, plen, tlen, admit) -> dict:
    """Phase 3, K5 and K5-int8 (results "K5" + tag, "K5-int8" + tag) on
    ragged_decode_case's inputs.  Live rows are held against the plain
    version; rows with no live key must come out exactly 0 (the plain
    version's mean of V there is discarded by every caller)."""
    from spacer_tpu_torch.ops import flash_decode as fd

    cases, dkw, live, work = ragged_decode_case(randn, gen, P, C, plen, tlen,
                                                admit)
    results = {}
    for kid, args in cases.items():
        out = fd.flash_ragged_decode_attention(*args, **dkw)
        if not bool(torch.isfinite(out).all()) or bool(out[~live].any()):
            raise RuntimeError(f"{kid}{tag}: non-finite values, or nonzero "
                               "rows for slots with no live key")
        results[kid + tag] = compare(
            f"{kid} flash_ragged_decode_attention R={len(plen)} Pmax={P} "
            f"Cmax={C} ({int(live.sum())} live slots)",
            lambda: fd.flash_ragged_decode_attention(*args, **dkw),
            lambda: fd.ragged_decode_attention_reference(*args, **dkw),
            lambda x: x[live], work=work[kid])
    return results


def check_int4_matmul(gen) -> dict:
    """Phase 3, K6: every (K, N) of the 7B int4 decode at M = 4 (serving
    slots) and 16 (rollout rows), against its plain version: the scale-free
    product (int4_matmul) within the f32 summation-order bound K6_SUM_TOL *
    sum |terms|, and dense_q4 (one launch: row scale, product, column
    scale, cast, bias) within that bound times the column scale plus one
    bf16 ulp at each of its two roundings.  Yardsticks: torch's
    _weight_int4pack_mm (tinygemm; the same codes + 8 as unsigned nibbles,
    group size 128, zero 0, scale 1 for the scale-free product and the
    column scale for dense_q4, repacked once outside the timing) and the
    bf16 torch.matmul on the widened weight, which the port never calls."""
    from spacer_tpu_torch.ops import int4_matmul as im
    from spacer_tpu_torch.ops import quant

    dev = gen.device
    results = {}
    for K, N in K6_SHAPES:
        codes, params = int4_dense_case(gen, K, N)
        packed = params["kernel_q4"]
        row_scale, col_scale = params["q4_row_scale"], params["q4_col_scale"]
        tinygemm = int4pack_yardstick(codes, col_scale)
        w_bf16 = codes.to(torch.bfloat16)
        for M in (4, 16):
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            allowed = (K6_SUM_TOL * (x.float().abs() @ codes.float().abs())
                       + 1e-6)
            q_bytes = K * N // 2 + M * K * 2
            lib = tinygemm(x, False)
            results[f"K6 M={M} K={K} N={N}"] = compare(
                f"K6 int4_matmul M={M} K={K} N={N}",
                lambda: im.int4_matmul(x, packed),
                lambda: im.int4_matmul_reference(x, packed), allowed=allowed,
                work=(q_bytes + M * N * 4, 2 * M * K * N), library_fn=lib)
            xs = (x * row_scale.to(x.dtype)).float()
            ref = quant.dense_q4_reference(params, x)
            allowed = (K6_SUM_TOL * (xs.abs() @ codes.float().abs()) * col_scale
                       + K6_BF16_ULP * (((xs @ codes.float()) * col_scale).abs()
                                        + ref.float().abs()) + 1e-6)
            lib = tinygemm(x, True)
            results[f"K6 dense_q4 M={M} K={K} N={N}"] = compare(
                f"K6 dense_q4 (fused) M={M} K={K} N={N}",
                lambda: quant.dense_q4(params, x),
                lambda: quant.dense_q4_reference(params, x), allowed=allowed,
                work=(q_bytes + K * 4 + N * (4 + 2 + M * 2), 2 * M * K * N),
                library_fn=lib)
            log(f"K6 M={M} K={K} N={N}: bf16 torch.matmul on the widened "
                f"weight {median_ms(lambda: torch.matmul(x, w_bf16)):.4f} ms")
            del allowed, xs, ref
        del codes, packed, params, tinygemm, w_bf16
        torch.cuda.empty_cache()
    M, K, N = K6_PATH_SHAPE
    results["K6"] = results[f"K6 dense_q4 M={M} K={K} N={N}"]
    return results


def int4_dense_case(gen, K, N):
    """An int4 dense of the decode path: random codes in [-7, 7] (K, N),
    packed, f32 row and column scales, a bf16 bias.  -> (codes, params)."""
    from spacer_tpu_torch.ops import int4_matmul as im

    dev = gen.device
    codes = torch.randint(-7, 8, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    return codes, {
        "kernel_q4": im.pack_int4(codes),
        "q4_row_scale": 0.1 + 2 * torch.rand((K,), generator=gen, device=dev),
        "q4_col_scale": 0.01 + torch.rand((N,), generator=gen, device=dev) / 50,
        "bias": torch.randn((N,), generator=gen, device=dev).to(torch.bfloat16)}


def int4pack_yardstick(codes, col_scale):
    """torch's int4 weight-only product (_weight_int4pack_mm) on the same
    codes (K, N): repacked once here as codes + 8 in unsigned nibbles,
    group size 128, zero 0.  -> fn(x, scaled) giving the call computing
    x @ codes (scale 1) or x @ (codes * col_scale), bf16 out, or None (and
    a log line with the error) if the op refuses on this card."""
    K, N = codes.shape
    try:
        q = (codes.to(torch.int32) + 8).t().contiguous()          # (N, K)
        w = torch._convert_weight_to_int4pack(
            (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
        zeros = torch.zeros((K // 128, N), device=codes.device)
        sz = {scaled: torch.stack([s.expand(K // 128, N), zeros], -1).to(
                  torch.bfloat16).contiguous()
              for scaled, s in ((False, torch.ones_like(col_scale)),
                                (True, col_scale))}

        def call(x, scaled):
            return torch._weight_int4pack_mm(x, w, 128, sz[scaled])

        x = torch.zeros((1, K), dtype=torch.bfloat16, device=codes.device)
        x[0, 0] = 1
        got = call(x, False)[0].float()
        err = float((got - codes[0].float()).abs().max())
        log(f"_weight_int4pack_mm K={K} N={N}: row 0 of the codes read back "
            f"with max abs err {err:.3e}")
    except (RuntimeError, TypeError) as e:
        log(f"_weight_int4pack_mm K={K} N={N}: refused on this card: "
            f"{str(e).splitlines()[0]}")
        return lambda x, scaled: None
    return lambda x, scaled: (lambda: call(x, scaled))


def dense_q8_cost(gen):
    """The int8 weight-only decode product (ops/quant.py dense_q8, which
    widens the int8 kernel to bf16 on every call and has no kernel of its
    own) against the bf16 product it replaces, at the rollout's M = 16 rows
    and each (K, N) of a 7B decoder layer and the head; the per-step sums
    are for TRAIN_LM_LAYERS layers plus the head."""
    from spacer_tpu_torch.ops.quant import dense_q8, quantize_dense_int8

    dev = gen.device
    per_layer = {(3584, 3584): 2, (3584, 512): 2, (3584, 18944): 2,
                 (18944, 3584): 1}
    step_q8 = step_bf16 = 0.0
    for (K, N), count in [*per_layer.items(), ((3584, 152064), None)]:
        w = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn((16, K), generator=gen, device=dev).to(torch.bfloat16)
        p8 = quantize_dense_int8({"kernel": w})
        q8 = median_ms(lambda: dense_q8(p8, x))
        bf = median_ms(lambda: torch.matmul(x, w))
        n = TRAIN_LM_LAYERS * count if count else 1
        step_q8, step_bf16 = step_q8 + n * q8, step_bf16 + n * bf
        log(f"dense_q8 M=16 K={K} N={N}: {q8:.4f} ms vs bf16 matmul "
            f"{bf:.4f} ms ({q8 / bf:.2f}x)")
        del w, p8
    log(f"dense_q8 per rollout decode step ({TRAIN_LM_LAYERS} layers + head): "
        f"{step_q8:.3f} ms vs bf16 {step_bf16:.3f} ms")
    torch.cuda.empty_cache()


def grouped_decode_case(randn, gen, P, pads, G, C=TRAIN_NEW_TOKENS):
    """K2's inputs: len(pads) prompts x G completions of group_q 7, Hkv 4,
    D 128, prefix P left-padded by `pads`, tails of C tokens; bf16
    caches for K2, int8 codes + f32 scales of the same values for K2-int8.
    -> (fn(step) -> {kernel id: args}, kwargs, fn(step) -> {kernel id:
    (bytes, bf16 operations)})."""
    from spacer_tpu_torch.ops import flash_decode as fd

    dev = gen.device
    Hkv, D, gq = 4, 128, 7
    Bd = len(pads)
    qd = randn(Bd, Hkv, G * gq, D)
    pk, pv = randn(Bd, Hkv, P, D), randn(Bd, Hkv, P, D)
    tk, tv = randn(Bd * G, Hkv, C, D), randn(Bd * G, Hkv, C, D)
    live = torch.ones((Bd, P), dtype=torch.bool, device=dev)
    for b, pad in enumerate(pads):
        live[b, :pad] = False
    bias_p = torch.where(live, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    q8 = [int8_cache(x, gen) for x in (pk, pv, tk, tv)]
    codes, scales = [c for c, _ in q8], [s_ for _, s_ in q8]

    def args(step):
        return {"K2": (qd, pk, pv, bias_p, tk, tv, step),
                "K2-int8": (qd, codes[0], codes[1], bias_p, codes[2], codes[3],
                            step, *scales)}

    # work: q, the prefix keys the bias keeps, the live tail, the bias, the
    # f32 output; per key 2 D bytes (bf16) or D + 4 (code + scale)
    n_prefix = Hkv * sum(P - p for p in pads)

    def work(step):
        n_tail = Bd * G * Hkv * step
        fixed = Bd * Hkv * G * gq * D * (2 + 4) + Bd * P * 4
        ops = 4 * D * (n_prefix * G * gq + n_tail * gq)
        return {"K2": (fixed + (n_prefix + n_tail) * 2 * D * 2, ops),
                "K2-int8": (fixed + (n_prefix + n_tail) * 2 * (D + 4), ops)}

    return args, dict(group=G, group_q=gq, sm_scale=D ** -0.5), work


def check_grouped_decode(randn, gen, P, pads, G, steps, results, tag="",
                         C=TRAIN_NEW_TOKENS):
    """Phase 3b, K2 and K2-int8 on grouped_decode_case's inputs at each live
    step of `steps`, against the plain version (results "K2" / "K2-int8" +
    tag + " P=.. step=..")."""
    from spacer_tpu_torch.ops import flash_decode as fd

    args, dkw, work = grouped_decode_case(randn, gen, P, pads, G, C)
    for step in steps:
        a, w = args(step), work(step)
        for kid in ("K2", "K2-int8"):
            results[f"{kid}{tag} P={P} step={step}"] = compare(
                f"{kid} flash_decode_attention{tag} P={P} pads {pads} "
                f"step={step}",
                lambda: fd.flash_decode_attention(*a[kid], **dkw),
                lambda: fd.decode_attention_reference(*a[kid], **dkw),
                work=w[kid])


def check_training_kernels(device="cuda") -> dict:
    """Phase 3b: K1, K1-bwd (dq, dk/dv) and K2 against their plain versions, at
    the training slice's shapes (prompt bucket TRAIN_PROMPT_BUCKET, padding
    TRAIN_PROMPT_PAD: one prompt in the update, it and its temporal shuffle
    in the rollout; these results go into the kernels line) and at a
    two-prompt batch (P=1024, one prompt padded by 300), which the slice's
    single row leaves out: a batch index past 0 and rows of differing
    padding."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def left_padded(P, pads):
        mask = torch.ones((len(pads), P), dtype=torch.bool, device=dev)
        for b, pad in enumerate(pads):
            mask[b, :pad] = False
        return mask

    results = {}
    H, Hkv, D = 28, 4, 128
    G, C = TRAIN_G, TRAIN_NEW_TOKENS
    path_P, path_pad = TRAIN_PROMPT_BUCKET, TRAIN_PROMPT_PAD
    # (P, padding of the update's prompts, of the rollout's prompts, steps)
    for P, pads, k2_pads, steps in (
            (path_P, (path_pad,), (path_pad, path_pad), (1, 100, C - 1)),
            (1024, (0, 300), (0, 300), (1, 100, C))):
        # prompt pass: B prompts, Sq=Skv=P; the padded query rows get no
        # output gradient (nothing downstream reads them)
        B = len(pads)
        mask = left_padded(P, pads)
        prompt = dict(causal=True, kv_mask=mask)
        q, k, v = randn(B, P, H, D), randn(B, P, Hkv, D), randn(B, P, Hkv, D)
        dout = randn(B, P, H, D) * mask[:, :, None, None]
        # completion pass: N=B*G rows, Sq=C completion tokens against
        # Skv=P+C keys at q_offset=P; each group's prompt padding,
        # completions ending at random lengths (later keys masked)
        N = B * G
        ends = torch.randint(1, C + 1, (N,), generator=gen, device=dev)
        cmask = torch.cat([mask.repeat_interleave(G, dim=0),
                           torch.arange(C, device=dev)[None] < ends[:, None]],
                          dim=1)
        completion = dict(causal=True, kv_mask=cmask, q_offset=P)
        qc, kc, vc, doutc = randn(N, C, H, D), randn(N, P + C, Hkv, D), \
            randn(N, P + C, Hkv, D), randn(N, C, H, D)
        # work of the backward: query rows (q, out, dout, dq bf16 + lse f32),
        # the key rows the masks keep (k, v, and dk, dv for dk/dv), and the
        # (query, key) pairs: 3 products per pair for dq, 4 for dk/dv
        causal_p = torch.ones((P, P), dtype=torch.bool, device=dev).tril()
        pad_c = torch.tensor(pads, device=dev).repeat_interleave(G)
        i = torch.arange(C, device=dev)
        comp_pairs = int((C * (P - pad_c)).sum()
                         + torch.minimum(i[None] + 1, ends[:, None]).sum())
        kv_rows = (P - pad_c + ends).sum().item()
        shapes = {
            "prompt": (sum(P - p for p in pads), sum(P - p for p in pads),
                       causal_pairs([P - p for p in pads]),
                       (causal_p[None] & mask[:, None, :])[:, None]),
            "completion": (N * C, kv_rows, comp_pairs,
                           (torch.cat([torch.ones((C, P), dtype=torch.bool,
                                                  device=dev),
                                       causal_p[:C, :C]], 1)[None]
                            & cmask[:, None, :])[:, None]),
        }
        for tag, (q_, k_, v_, do_, kw), (q_rows, k_rows, pairs, sdpa_mask) in (
                (f"prompt B={B} S={P}", (q, k, v, dout, prompt),
                 shapes["prompt"]),
                (f"completion N={N} Sq={C} Skv={P + C}",
                 (qc, kc, vc, doutc, completion), shapes["completion"])):
            # the forward at the training shapes (valid query rows compared)
            live_q = (torch.arange(q_.shape[1], device=dev)[None] + kw.get(
                "q_offset", 0)) >= torch.tensor(pads, device=dev).repeat_interleave(
                q_.shape[0] // B)[:, None]
            results[f"K1 {tag}"] = compare(
                f"K1 flash_attention [{tag}]",
                lambda: fa.flash_attention(q_, k_, v_, **kw),
                lambda: xla_attention(q_, k_, v_, **kw), lambda x: x[live_q],
                work=(q_rows * H * D * 2 * 2 + k_rows * Hkv * D * 2 * 2
                      + q_rows * H * 4, 4 * D * H * pairs),
                library_fn=lambda: sdpa_masked(q_, k_, v_, sdpa_mask))
            out, lse = fa.flash_attention(q_, k_, v_, return_lse=True, **kw)
            args = (q_, k_, v_, out, lse, do_)
            # delta = rowsum(dout * out): torch ops that each public dq and
            # dk/dv call below runs (the autograd backward runs them once)
            delta_dev = device_ms(lambda: fa._delta(out, do_))
            log(f"K1-bwd delta [{tag}]: device_ms "
                + ("not measured" if delta_dev is None else f"{delta_dev:.4f}")
                + " (inside each dq and dk/dv call's device_ms below)")
            grads = (*fa.flash_attention_bwd_dq(*args, **kw),
                     *fa.flash_attention_bwd_dkv(*args, **kw))
            if not all(bool(torch.isfinite(g).all()) for g in grads):
                raise RuntimeError(f"K1-bwd wrote non-finite gradients ({tag})")
            # library: the backward of torch's SDPA (dq, dk and dv in one)
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q_, k_, v_))
            lout = sdpa_masked(lq, lk, lv, sdpa_mask)

            def library(lout=lout, lq=lq, lk=lk, lv=lv, do_=do_):
                return torch.autograd.grad(lout, (lq, lk, lv), do_,
                                           retain_graph=True)

            q_bytes = q_rows * (H * D * 2 + H * 4)     # q, out, dout, lse
            results[f"K1-bwd dq {tag}"] = compare(
                f"K1-bwd dq [{tag}]",
                lambda: fa.flash_attention_bwd_dq(*args, **kw),
                lambda: fa.attention_bwd_reference(q_, k_, v_, do_, **kw)[0],
                rel_norm=True, library_fn=library,
                work=(q_bytes + q_rows * H * D * 2 * 3
                      + k_rows * Hkv * D * 2 * 2, 6 * D * H * pairs))
            # dk/dv: its bound is the function's own work; the f32 partial
            # sums that the split design adds (each written once and read
            # once, over every key row) are logged beside it, not counted
            dkv_work = (q_bytes + q_rows * H * D * 2 * 2
                        + k_rows * Hkv * D * 2 * 4, 8 * D * H * pairs)
            splits = (fa.dkv_split_count(q_, k_) if dev.type == "cuda"
                      else 1)
            partial_bytes = 2 * 2 * splits * k_.numel() * 4 if splits > 1 else 0
            design = roofline(dkv_work[0] + partial_bytes, dkv_work[1])
            log(f"K1-bwd dk/dv [{tag}]: splits {splits}, f32 partials "
                f"{partial_bytes / 1e6:.1f} MB, design bound "
                f"{design['bound_ms']:.4f} ms ({design['bound_by']})")
            results[f"K1-bwd dkv {tag}"] = compare(
                f"K1-bwd dk/dv [{tag}]",
                lambda: fa.flash_attention_bwd_dkv(*args, **kw),
                lambda: fa.attention_bwd_reference(q_, k_, v_, do_, **kw)[1:],
                rel_norm=True, library_fn=library, work=dkv_work)
            del lout, lq, lk, lv

        check_grouped_decode(randn, gen, P, k2_pads, G, steps, results)
    # K2 / K2-int8 at K2_WIDE_G completions per prompt, the path's prompts
    check_grouped_decode(randn, gen, path_P, (path_pad, path_pad), K2_WIDE_G,
                         (1, 100, C - 1), results, tag=f" G={K2_WIDE_G}")
    # K2 / K2-int8 as the eval's static path runs them (phase 7): one
    # completion per prompt, 2 prompts of differing padding at its bucket
    check_grouped_decode(randn, gen, EVAL_PROMPT_BUCKET, EVAL_PROMPT_PADS, 1,
                         (1, 33, EVAL_NEW_TOKENS - 1), results, tag=" G=1",
                         C=EVAL_NEW_TOKENS)
    results["K1-bwd dq"] = results[f"K1-bwd dq prompt B=1 S={path_P}"]
    results["K1-bwd dkv"] = results[f"K1-bwd dkv prompt B=1 S={path_P}"]
    results["K2"] = results[f"K2 P={path_P} step={C - 1}"]
    results["K2-int8"] = results[f"K2-int8 P={path_P} step={C - 1}"]
    return results


class SliceProbe:
    """Observes the serving slice from outside: wraps the batcher's prologue
    (ViT), prefill, decode step, sampler and harvest with synchronised
    timers and finiteness checks, and records every sampled step's logits
    (of the rows with a live key) and tokens.  With `replay` (the tokens of an earlier run) the sampler
    returns those tokens instead, so a second run sees identical inputs at
    every step."""

    def __init__(self, replay=None):
        import spacer_tpu_torch.serving.batcher as bm

        self.bm, self.replay = bm, replay
        self.vit_ms, self.prefill_ms, self.decode_ms = [], [], []
        self.lengths, self.nonfinite = [], 0
        self.live = None   # rows of the next sampled logits that are kept
        self.logits, self.tokens = [], []
        self._saved = (bm.prologue, bm.lm_forward, bm.ragged_decode_step,
                       bm.sample_logits, bm.ContinuousBatcher.poll_finished)

    def _timed(self, sink, fn, check_logits):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            if sink is not None:
                sink.append((time.perf_counter() - t0) * 1e3)
            logits = out[0] if isinstance(out, tuple) else out
            if check_logits and not bool(torch.isfinite(logits).all()):
                self.nonfinite += 1
            return out
        return wrapped

    def __enter__(self):
        bm = self.bm
        prologue, lm_forward, step, sample, poll = self._saved

        def timed_prologue(params, ids, px, **kw):
            sink = self.vit_ms if px is not None else None
            return self._timed(sink, prologue, False)(params, ids, px, **kw)

        def recorded_sample(logits, *a, **kw):
            tokens = sample(logits, *a, **kw)
            if self.replay is not None:
                tokens = self.replay[len(self.tokens)]
            kept = logits if self.live is None else logits[self.live]
            self.logits.append(kept.float())
            self.tokens.append(tokens)
            return tokens

        def poll_finished(batcher):
            done = poll(batcher)
            self.lengths += [o.length for _, o in done]
            return done

        timed_prefill = self._timed(self.prefill_ms, lm_forward, True)
        timed_step = self._timed(self.decode_ms, step, True)

        def prefill(*a, **kw):
            self.live = None   # the admitted rows, all sampled
            return timed_prefill(*a, **kw)

        def decode_step(layers, params, cfg, cur, pos3, caches, ring_idx,
                        prefix_mask, ring_mask):
            # a slot with no live key (empty) is discarded by the batcher,
            # and K5 writes 0 for it where the plain version writes the mean
            # of V: its logits are not compared
            self.live = prefix_mask.any(1) | ring_mask.any(1)
            return timed_step(layers, params, cfg, cur, pos3, caches,
                              ring_idx, prefix_mask, ring_mask)

        bm.prologue = timed_prologue
        bm.lm_forward = prefill
        bm.ragged_decode_step = decode_step
        bm.sample_logits = recorded_sample
        bm.ContinuousBatcher.poll_finished = poll_finished
        return self

    def __exit__(self, *exc):
        (self.bm.prologue, self.bm.lm_forward, self.bm.ragged_decode_step,
         self.bm.sample_logits, self.bm.ContinuousBatcher.poll_finished) = \
            self._saved


class PlainAttention:
    """For a reference run only: routes the slices' kernel calls (attention,
    and K6 in the int4 weight products, dense_q4) to the kernels' plain
    versions (the library itself has no such switch)."""

    def __enter__(self):
        import spacer_tpu_torch.models.qwen25_vl.language as lang
        import spacer_tpu_torch.models.qwen25_vl.vision as vis
        import spacer_tpu_torch.ops.quant as quant
        import spacer_tpu_torch.serving.ragged as rag
        from spacer_tpu_torch.nn.attention import xla_attention
        from spacer_tpu_torch.ops import flash_decode as fd
        from spacer_tpu_torch.ops import vit_window_attention as vwa

        self.routes = [
            (lang, "dot_product_attention", xla_attention),
            (lang, "flash_decode_attention", fd.decode_attention_reference),
            (vis, "window_attention_hsd", vwa.window_attention_reference),
            (vis, "chunk_attention_hsd", vwa.chunk_attention_reference),
            (rag, "flash_ragged_decode_attention",
             fd.ragged_decode_attention_reference),
            (quant, "dense_q4", quant.dense_q4_reference),
        ]
        self.saved = [getattr(m, n) for m, n, _ in self.routes]
        for m, n, plain in self.routes:
            setattr(m, n, plain)
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.routes, self.saved):
            setattr(m, n, fn)


def serve_slice(cfg, device="cuda") -> dict:
    """Phases 4 and 4b: the serving slice (at full Qwen2.5-VL-7B geometry
    when called from main) with bf16 decode, then with decode_quant=
    "int4_kv"; each run is followed by the same requests with the kernels
    replaced by their plain versions and the run's tokens replayed: the
    logits of every sampled step must agree.  Returns the launches of each
    path, {path: {kernel id: count}}."""
    params, proc, msgs = serving_setup(cfg, device)
    counts, bf16 = serve_run(cfg, params, proc, msgs, None, SERVE_KERNELS)
    counts_q, quant = serve_run(cfg, params, proc, msgs, "int4_kv",
                                SERVE_INT4_KV_KERNELS)
    agree = float(torch.cat([(a == b).float()
                             for a, b in zip(bf16.tokens, quant.tokens)
                             if a.shape == b.shape]).mean())
    log(f"slice int4_kv vs bf16: {agree:.4f} of the sampled tokens agree "
        f"(not gated) | decode ms per step median "
        f"{statistics.median(quant.decode_ms):.2f} vs "
        f"{statistics.median(bf16.decode_ms):.2f}")
    return {"serve": counts, "serve int4_kv": counts_q}


def serving_setup(cfg, device="cuda"):
    """The serving slice's inputs: random bf16 params from seed 0, the
    processor (MockTokenizer), and 2 video (16 frames 360x640) + 2 text
    (~200 words) conversations.  -> (params, processor, messages)."""
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init: {n_params / 1e9:.2f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg,
                       device=device)
    rng = np.random.default_rng(0)
    words = [f"word{i}" for i in range(5000)]

    def video(question):
        frames = rng.integers(0, 256, (16, 360, 640, 3), np.uint8)
        return [{"role": "user", "content": [
            {"type": "video", "video": frames, "fps": 2.0},
            {"type": "text", "text": question}]}]

    def text(n_words):
        return [{"role": "user",
                 "content": " ".join(rng.choice(words, n_words))}]

    msgs = [video("how many chairs are in the room"), text(200),
            video("which object is closest to the door"), text(190)]
    return params, proc, msgs


SERVE_GEN_KW = dict(max_new_tokens=64, temperature=0.0, slots=4)


def serve_run(cfg, params, proc, msgs, decode_quant, kernels):
    """One serving path and its plain replay (see serve_slice)."""
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"slice[{decode_quant or 'bf16'}]"
    gen_kw = SERVE_GEN_KW
    engine = QwenEngine(cfg, params, proc, decode_quant=decode_quant)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with SliceProbe() as probe:
        t0 = time.perf_counter()
        texts = engine.generate_many(msgs, **gen_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    grid = engine.encode_request(msgs[0])["grid_thw"]
    tokens = sum(probe.lengths)
    log(f"{tag}: {len(texts)} completions, lengths {probe.lengths}, video "
        f"grid {grid}, wall {wall:.2f} s (the batcher's weight quantization "
        f"included), {tokens / wall:.1f} generated tok/s")
    log(f"{tag}: ViT encode ms {[round(x, 2) for x in probe.vit_ms]} | prefill "
        f"ms per admission {[round(x, 2) for x in probe.prefill_ms]} | decode "
        f"ms per step median {statistics.median(probe.decode_ms):.2f} over "
        f"{len(probe.decode_ms)} steps")
    log(f"{tag}: launches {counts} | max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    if len(probe.lengths) != len(msgs) or min(probe.lengths) < 1:
        raise RuntimeError(f"a request emitted no token: {probe.lengths}")
    if probe.nonfinite:
        raise RuntimeError(f"{probe.nonfinite} non-finite logits tensors")
    if grid != ((8, 16, 30),):
        raise RuntimeError(f"unexpected video grid {grid}")
    if min(counts[k] for k in kernels) < 1:
        raise RuntimeError(f"a kernel of the path was never launched: {counts}")
    del engine

    # reference run: plain versions everywhere, the kernel run's tokens
    with PlainAttention(), SliceProbe(replay=probe.tokens) as ref:
        QwenEngine(cfg, params, proc, decode_quant=decode_quant
                   ).generate_many(msgs, **gen_kw)
    if launch_counts() != counts or len(ref.logits) != len(probe.logits):
        raise RuntimeError("the reference run launched a kernel or took "
                           "other steps")
    cos = torch.stack([torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
                       for a, b in zip(probe.logits, ref.logits)])
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(probe.logits, ref.logits)]).mean()
    log(f"{tag} vs plain versions: logits cosine min {float(cos.min()):.5f} "
        f"median {float(cos.median()):.5f} over {len(cos)} sampled steps "
        f"(tol {SLICE_COS_TOL}) | greedy argmax agreement {float(agree):.4f}")
    if not float(cos.min()) >= SLICE_COS_TOL:
        raise RuntimeError("the kernel path's logits disagree with the plain "
                           "versions' path")
    probe.logits = ref.logits = None
    return counts, probe


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def synthetic_reward(completions, **kwargs):
    """A reward that varies over the completions of a random-weight model
    (whose accuracy and format rewards are 0 everywhere, which would make
    every advantage and so every gradient 0): a hash of the decoded token
    ids, mod 5."""
    return [float(sum(map(ord, c[0]["content"])) % 5) for c in completions]


def _grad_group(name: str) -> str:
    """Tensor group of a param path for the gradient cosine report."""
    parts = name.split("/")
    if parts[:2] == ["model", "layers"]:
        kind = parts[3]
        return (f"lm {parts[4]}" if kind == "self_attn"
                else "lm mlp" if kind == "mlp" else "lm norms")
    if parts[:2] == ["visual", "blocks"]:
        kind = parts[3]
        return (f"vit attn {parts[4]}" if kind == "attn"
                else "vit mlp" if kind == "mlp" else "vit norms")
    return "/".join(parts[:2])


def k2_checked(step: int) -> bool:
    """Rollout steps whose K2 calls phase 5 holds against the plain version."""
    return step % K2_CHECK_EVERY == 1


class DecodeProbe:
    """Times every grouped-rollout decode step (synchronised), holds the
    K2 / K2-int8 calls of the k2_checked steps against
    decode_attention_reference on the same live inputs (the plain call
    launches nothing, so the path's launch count is unchanged), and counts
    the sampled steps whose logits are not all finite."""

    def __enter__(self):
        import spacer_tpu_torch.models.qwen25_vl.language as lang
        import spacer_tpu_torch.ops.flash_decode as fd
        import spacer_tpu_torch.sampler.sampler as sm

        self.sm, self.lang = sm, lang
        self.saved = (sm.lm_decode_step_split, lang.flash_decode_attention,
                      sm.sample_logits)
        step_fn, k2, sample = self.saved
        self.ms, self.k2_err, self.k2_shapes, self.k2_bad = [], [], set(), 0
        self.logit_steps, self.nonfinite = 0, 0

        def finite_checked(logits, *a, **kw):
            # every sampled step's logits: the prefill's last and each
            # decode step's
            self.logit_steps += 1
            self.nonfinite += not bool(torch.isfinite(logits).all())
            return sample(logits, *a, **kw)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms.append((kw["tail_len"], (time.perf_counter() - t0) * 1e3))
            return out

        def checked(q, pk, pv, bias_p, tk, tv, step, *scales, **kw):
            out = k2(q, pk, pv, bias_p, tk, tv, step, *scales, **kw)
            if k2_checked(step):
                ref = fd.decode_attention_reference(q, pk, pv, bias_p, tk, tv,
                                                    step, *scales, **kw)
                diff = (out - ref).abs()
                self.k2_err.append(float(diff.max()))
                self.k2_bad += not (bool(torch.isfinite(out).all()) and bool(
                    (diff <= BF16_TOL * (1 + ref.abs())).all()))
                self.k2_shapes.add((tuple(q.shape), pk.shape[2], tk.shape[2]))
            return out

        sm.lm_decode_step_split = timed
        lang.flash_decode_attention = checked
        sm.sample_logits = finite_checked
        return self

    def __exit__(self, *exc):
        (self.sm.lm_decode_step_split, self.lang.flash_decode_attention,
         self.sm.sample_logits) = self.saved

    def decode_ms(self):
        """Per-step times of the steps whose K2 calls were not checked."""
        return [ms for step, ms in self.ms if not k2_checked(step)]


def replay_first_step(step_fn, names, params, batch, kw):
    """The first update's loss and backward, once with the kernels and once
    with plain attention, on the same params and batch.  Every trainable
    tensor must get a finite, nonzero gradient from the kernel run, the
    plain run must launch no kernel, and each tensor group's gradient
    cosine against the plain run must be >= GRAD_COS_TOL.  Returns the
    kernel launches this check made (they are comparisons, not the path's)
    and its seconds."""
    from spacer_tpu_torch.ops import launch_counts

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = (params, batch["ref_logps"],
            {k: v for k, v in batch.items() if k != "ref_logps"},
            kw["grid_thw"], kw["num_generations"])
    before = launch_counts()
    loss_k, _, gk = step_fn.loss_and_grads(*args)
    after = launch_counts()
    extra = {k: n - before[k] for k, n in after.items()}
    bad = [n for n, g in zip(names, gk)
           if not (bool(torch.isfinite(g).all()) and bool(g.any()))]
    if bad:
        raise RuntimeError(f"{len(bad)} trainable tensors got a zero or "
                           f"non-finite gradient: {bad[:8]}")
    with PlainAttention():
        loss_p, _, gp = step_fn.loss_and_grads(*args)
    if launch_counts() != after:
        raise RuntimeError("the plain-attention replay launched a kernel")
    sums = {}
    for n, a, b in zip(names, gk, gp):
        a, b = a.float(), b.float()
        s = sums.setdefault(_grad_group(n), [0.0, 0.0, 0.0])
        s[0] += float((a * b).sum())
        s[1] += float(a.square().sum())
        s[2] += float(b.square().sum())
    del gk, gp
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cos = {g: d / math.sqrt(x * y) for g, (d, x, y) in sums.items()}
    log(f"train: {len(names)} trainable tensors, all with finite nonzero "
        f"gradients | step-1 loss kernel {float(loss_k):.6e} plain "
        f"{float(loss_p):.6e} | replay {seconds:.2f} s")
    log("train: gradient cosine kernel vs plain attention per group: "
        + ", ".join(f"{g} {c:.5f}" for g, c in sorted(cos.items())))
    if not min(cos.values()) >= GRAD_COS_TOL:
        raise RuntimeError(f"gradient cosine below {GRAD_COS_TOL}: {cos}")
    return extra, seconds


def make_trainer(cfg, device, steps: int, out_dir: str, **overrides):
    """The training slice's SGRLVRTrainer at the widths of `cfg`: random
    bf16 weights from seed 0, one 16-frame 360x640 video row, temporal
    shuffle merged into the rollout (2 prompts x TRAIN_G completions of up
    to TRAIN_NEW_TOKENS tokens), the trainer's default int8_kv rollouts,
    beta 0.04, int8 moments, `steps` steps; `overrides` replace
    SGRLVRConfig fields.  Returns (trainer, the params' paths in
    param_leaves order)."""
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor, make_conversation
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.rewards import accuracy_reward, format_reward
    from spacer_tpu_torch.train.step import param_leaves
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    names = [n for n, _ in param_leaves(params)]
    n_params = sum(t.numel() for _, t in param_leaves(params))
    log(f"train init: {n_params / 1e9:.2f} B params bf16, LM "
        f"{cfg.text.num_layers} layers, in {time.perf_counter() - t0:.1f} s")
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg,
                       device=device)
    frames = np.random.default_rng(1).integers(0, 256, (16, 360, 640, 3),
                                               np.uint8)
    row = {"problem": "How many chairs are in the room?",
           "problem_type": "numerical", "solution": "<answer>3</answer>",
           "path": frames, "data_type": "video", "data_source": "synthetic",
           "problem_id": 0}
    row.update(make_conversation(row))
    shutil.rmtree(out_dir, ignore_errors=True)
    args = SGRLVRConfig(
        num_generations=TRAIN_G, max_completion_length=TRAIN_NEW_TOKENS,
        temperature=1.0, top_p=0.95, beta=0.04, temporal=True,
        moment_dtype="int8", max_steps=steps,
        num_train_epochs=steps, logging_steps=1, save_steps=10 ** 9,
        skip_failed_steps=False, output_dir=out_dir, seed=0)
    args = dataclasses.replace(args, **overrides)
    trainer = SGRLVRTrainer(
        cfg, params, proc, [synthetic_reward, accuracy_reward, format_reward],
        [row], args)
    return trainer, names


def train_slice(cfg, device="cuda") -> dict:
    """Phases 5 and 5b: two SG-RLVR optimizer steps through
    SGRLVRTrainer.train at the widths of `cfg` (make_trainer): merged
    int8_kv rollout (K1 prefill + K2-int8 decode, held against its plain
    version on live inputs), rewards, group advantages, reference logps, the
    shared-prefix policy forward/backward (K1, K1-bwd, K3, K4) and the
    int8-moment AdamW update.  The first update is replayed with plain
    attention (replay_first_step); the replay's time is reported apart from
    the steps'.  Then one bf16 rollout of the first step's batch
    (rollout_bf16).  Returns {path: {kernel id: count}}."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    out_dir = str(pathlib.Path(__file__).resolve().parent / "build" / "smoke_train")
    trainer, names = make_trainer(cfg, device, 2, out_dir)
    step_fn, steps, extra, replay_s = trainer.step_fn, [], {}, []

    def spy(params, ref_params, opt_state, batch, **kw):
        if not steps:
            e, sec = replay_first_step(step_fn, names, params, batch, kw)
            extra.update(e)
            replay_s.append(sec)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, ref_params, opt_state, batch, **kw)
        torch.cuda.synchronize()
        steps.append(dict({k: float(v) for k, v in out[2].items()},
                          update_s=time.perf_counter() - t,
                          prompt_len=batch["prompt_ids"].shape[1],
                          prompt_pad=int((batch["prompt_mask"] == 0).sum()),
                          lengths=batch["completion_mask"].sum(1).tolist()))
        return out

    spy.ref_logps_fn = step_fn.ref_logps_fn
    trainer.step_fn = spy
    rollouts, generate = [], trainer.sampler.generate

    def recorded_generate(*a, **kw):
        if not rollouts:
            rollouts.append((a, kw))
        return generate(*a, **kw)

    trainer.sampler.generate = recorded_generate
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with DecodeProbe() as probe:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: n - extra.get(k, 0) for k, n in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    with open(pathlib.Path(out_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    for i, (st, rec) in enumerate(zip(steps, records)):
        log(f"train step {i + 1}: loss {st['loss']:.6e} kl {st['kl']:.6e} "
            f"grad_norm {st['grad_norm']:.6e} | rollout "
            f"{rec['time/rollout_s']:.2f} s, reward {rec['time/reward_s']:.3f} "
            f"s, update {st['update_s']:.2f} s | prompt bucket "
            f"{st['prompt_len']} (pad {st['prompt_pad']}), completion lengths "
            f"{st['lengths']}")
    replay = sum(replay_s)
    log(f"train: decode_quant {trainer.args.decode_quant!r} | wall "
        f"{wall:.1f} s = {len(steps)} steps {wall - replay:.1f} s "
        f"+ first-step replay (kernel and plain backward) {replay:.1f} s | "
        f"rollout decode ms per step median "
        f"{statistics.median(probe.decode_ms()):.2f} over "
        f"{len(probe.decode_ms())} unchecked steps of the "
        f"{cfg.text.num_layers}-layer LM | max_memory_allocated "
        f"{peak / 2**30:.2f} GiB | launches {counts}")
    log(f"train: K2-int8 vs plain on live rollout inputs: {len(probe.k2_err)} "
        f"calls at (q shape, P, T) {sorted(probe.k2_shapes)}, max_abs_err "
        f"{max(probe.k2_err, default=float('nan')):.3e} (tol {BF16_TOL:.0e} "
        f"* (1 + |ref|)), {probe.k2_bad} outside")
    if trainer.global_step != 2 or len(steps) != 2:
        raise RuntimeError(f"expected 2 optimizer steps, got {len(steps)}")
    for st in steps:
        if (st["prompt_len"], st["prompt_pad"]) != (TRAIN_PROMPT_BUCKET,
                                                    TRAIN_PROMPT_PAD):
            raise RuntimeError(
                f"prompt bucket {st['prompt_len']} pad {st['prompt_pad']}: "
                f"phase 3b checked K1-bwd and K2 at {TRAIN_PROMPT_BUCKET} "
                f"pad {TRAIN_PROMPT_PAD}")
        if not all(math.isfinite(st[k]) for k in ("loss", "kl", "grad_norm")):
            raise RuntimeError(f"non-finite step metrics {st}")
    if not probe.k2_err or probe.k2_bad:
        raise RuntimeError(f"K2-int8 disagrees with its plain version on "
                           f"{probe.k2_bad} of {len(probe.k2_err)} live calls")
    opt = trainer.opt_state
    moved = [g for g, (_, ms), (_, vs) in zip(opt.groups, opt.mu, opt.nu)
             if bool(ms.any()) and bool(vs.any())]
    if opt.count != 2 or len(moved) != len(opt.groups):
        raise RuntimeError(f"int8 moments did not move for "
                           f"{len(opt.groups) - len(moved)} moment groups")
    log(f"train: int8 moments moved for all {len(opt.groups)} moment groups "
        f"({len(names)} tensors)")
    if min(counts[k] for k in TRAIN_KERNELS) < 1:
        raise RuntimeError(f"a kernel of the training path was never "
                           f"launched: {counts}")
    a, kw = rollouts[0]
    return {"train int8_kv": counts,
            "rollout bf16": rollout_bf16(trainer, a, kw)}


def rollout_bf16(trainer, args, kwargs) -> dict:
    """Phase 5b: the first training step's rollout again, bf16 decode
    (Sampler(decode_quant=None)), on the trained params: K2 held against its
    plain version on the live inputs of the k2_checked steps.  Returns the
    path's launches."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.sampler import Sampler

    sampler = Sampler(trainer.cfg, eos_token_id=trainer.sampler.eos_token_id,
                      pad_token_id=trainer.sampler.pad_token_id,
                      length_bucket=trainer.sampler.length_bucket)
    args = (*args[:2], trainer.params, *args[3:])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with DecodeProbe() as probe:
        t0 = time.perf_counter()
        out = sampler.generate(*args, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"rollout bf16: {out.sequences.shape[0]} completions in {wall:.2f} s, "
        f"decode ms per step median {statistics.median(probe.decode_ms()):.2f} "
        f"over {len(probe.decode_ms())} unchecked steps | max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
        f"{counts}")
    log(f"rollout bf16: K2 vs plain on live inputs: {len(probe.k2_err)} calls, "
        f"max_abs_err {max(probe.k2_err, default=float('nan')):.3e}, "
        f"{probe.k2_bad} outside")
    if not probe.k2_err or probe.k2_bad:
        raise RuntimeError(f"K2 disagrees with its plain version on "
                           f"{probe.k2_bad} of {len(probe.k2_err)} live calls")
    if min(counts[k] for k in ROLLOUT_BF16_KERNELS) < 1:
        raise RuntimeError(f"a kernel of the bf16 rollout was never launched: "
                           f"{counts}")
    return counts


def checkpoint_phase(device="cuda"):
    """Phase 6: random bf16 params at Qwen2.5-VL-7B widths with the LM cut
    to CKPT_LM_LAYERS layers, written by export_to_safetensors in HF's
    sharded layout (index + at least 2 shards) under build/, loaded back by
    load_params_from_hf onto the card: every tensor must equal the written
    one bitwise.  Logs write and load seconds and GB/s, and the host's
    peak RSS growth during the load (sampled every 5 ms)."""
    import tempfile
    import threading

    from spacer_tpu_torch.models.qwen25_vl import (
        QWEN25_VL_7B,
        export_to_safetensors,
        init_params,
        load_params_from_hf,
    )
    from spacer_tpu_torch.models.qwen25_vl.safetensors_io import INDEX_FILE

    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=CKPT_LM_LAYERS))
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    leaves = list(_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 1.25 * n_bytes:
        raise RuntimeError(f"phase 6 writes {n_bytes / 1e9:.2f} GB under "
                           f"{root}, which has {free / 1e9:.2f} GB free")
    tmp = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=root)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_to_safetensors(params, cfg, tmp,
                              max_shard_bytes=CKPT_SHARD_BYTES)
        write_s = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(tmp) if f.endswith(".safetensors"))
        if len(shards) < 2 or not os.path.exists(os.path.join(tmp, INDEX_FILE)):
            raise RuntimeError(f"expected an index and >= 2 shards: {shards}")
        page = os.sysconf("SC_PAGE_SIZE")

        def rss():
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * page

        base, peak, done = rss(), [0], threading.Event()

        def sample():
            while not done.is_set():
                peak[0] = max(peak[0], rss())
                time.sleep(0.005)

        sampler = threading.Thread(target=sample)
        sampler.start()
        try:
            t0 = time.perf_counter()
            loaded, lcfg = load_params_from_hf(tmp, device=device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            done.set()
            sampler.join()
        n_got, bad = len(list(_leaves(loaded))), _tree_diff(params, loaded)
        log(f"checkpoint: {sum(t.numel() for t in leaves) / 1e9:.2f} B params "
            f"bf16 (LM {CKPT_LM_LAYERS} layers, ViT {cfg.vision.depth} blocks, "
            f"vocab {cfg.text.vocab_size}), {n_bytes / 1e9:.3f} GB in "
            f"{len(shards)} shards | write {write_s:.2f} s "
            f"({n_bytes / write_s / 1e9:.3f} GB/s) | load to the card "
            f"{load_s:.2f} s ({n_bytes / load_s / 1e9:.3f} GB/s; the shards "
            f"were just written, so mostly read from the page cache) | host "
            f"peak RSS growth during the load {(peak[0] - base) / 1e9:.3f} GB "
            f"| {n_got} tensors, {bad} differ from the written ones")
        if (n_got != len(leaves) or bad or lcfg.text != cfg.text
                or lcfg.vision != cfg.vision):
            raise RuntimeError(f"the loaded checkpoint differs from the "
                               f"written one: {bad} of {len(leaves)} tensors")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _tree_diff(a, b) -> int:
    """Leaves of two param trees that differ in dtype, shape, device or any
    bit of their values; a difference of structure counts as one."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return 1
        return sum(_tree_diff(a[k], b[k]) for k in a)
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return 1
        return sum(map(_tree_diff, a, b))
    return int(not (a.dtype == b.dtype and a.shape == b.shape
                    and a.device == b.device and torch.equal(a, b)))


def _median(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


def write_eval_data(root: pathlib.Path):
    """Phase 7's LongVideoBench data: 2 synthetic mp4 videos (360x640,
    EVAL_VIDEO_SECONDS at EVAL_VIDEO_FPS, written with cv2) and a JSON file
    of 4 rows over them, with questions of differing lengths.
    -> (data file, video directory)."""
    import cv2

    rng = np.random.default_rng(3)
    for i in range(2):
        w = cv2.VideoWriter(str(root / f"v{i}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), EVAL_VIDEO_FPS,
                            (640, 360))
        base = rng.integers(0, 256, (360, 640, 3), np.uint8)
        for t in range(EVAL_VIDEO_SECONDS * EVAL_VIDEO_FPS):
            w.write(np.roll(base, 7 * t, axis=1))
        w.release()
    questions = [
        ("What happens first in the video?", ["a door opens", "a cup falls",
                                              "nothing moves", "a light"]),
        ("Which object is closest to the camera at the end of the clip, "
         "after the person walks past the table?", ["chair", "lamp"]),
        ("How many times does the scene change?", ["one", "two", "three"]),
        ("Where is the bag?", ["left", "right", "on the table", "gone",
                               "under the bed"]),
    ]
    rows = [{"id": i, "video_id": f"v{i % 2}", "question": q,
             "candidates": c, "correct_choice": i % len(c),
             "question_category": ("S2E", "E3E")[i % 2],
             "topic_category": "synthetic", "duration": EVAL_VIDEO_SECONDS}
            for i, (q, c) in enumerate(questions)]
    data_file = root / "lvb.json"
    data_file.write_text(json.dumps(rows))
    return str(data_file), str(root)


class RecordingEngine:
    """Wraps a QwenEngine for phase 7.  run_worker turns any exception of
    the engine into "" answers (the reference's semantics), so a kernel
    that fails would let the eval pass: this keeps every exception that
    generate / generate_many raise before re-raising it.  It also records
    each processor call's video grids, padded length and valid lengths, and
    the completion lengths of the static path."""

    def __init__(self, engine):
        self.engine, self.errors, self.prompts, self.lengths = engine, [], [], []
        process = engine.processor.process_messages
        generate = engine.sampler.generate

        def recorded_process(*a, **kw):
            enc = process(*a, **kw)
            grids = enc.get("video_grid_thw")
            self.prompts.append((
                [tuple(int(x) for x in g) for g in np.asarray(grids)]
                if grids is not None else [],
                int(np.asarray(enc["input_ids"]).shape[1]),
                np.asarray(enc["attention_mask"]).sum(1).tolist()))
            return enc

        def recorded_generate(*a, **kw):
            out = generate(*a, **kw)
            self.lengths += out.lengths.tolist()
            return out

        engine.processor.process_messages = recorded_process
        engine.sampler.generate = recorded_generate

    def _call(self, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception:
            import traceback

            self.errors.append(traceback.format_exc())
            raise

    def generate(self, *a, **kw):
        return self._call(self.engine.generate, *a, **kw)

    def generate_many(self, *a, **kw):
        return self._call(self.engine.generate_many, *a, **kw)


def eval_slice(cfg, device="cuda") -> dict:
    """Phase 7: cli/evaluate.py's path (run_benchmark -> QwenEngine ->
    processor -> ViT -> prefill -> decode) at the geometry of `cfg` (full
    Qwen2.5-VL-7B from main), random bf16 weights from seed 0, MockTokenizer,
    on write_eval_data's 4 LongVideoBench rows: once serving="static"
    (Sampler.generate: K1, K3, K4, K2 at G = 1, its K2 calls of the
    k2_checked steps held against the plain version live, every sampled
    step's logits finite) and once serving="continuous" (the batcher: K1,
    K3, K4, K5; logits finite).  Each run must write 4 records, raise no
    exception in the engine, score LongVideoBench's metric keys, see only
    EVAL_GRID and EVAL_PROMPT_BUCKET, and launch its kernels.  Returns
    {path: {kernel id: count}}."""
    import tempfile

    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.evalharness import EvalConfig, QwenEngine, run_benchmark
    from spacer_tpu_torch.evalharness.util import read_jsonl
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.ops.quant import quantize_decode_model

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    log(f"eval init: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B "
        f"params bf16 in {time.perf_counter() - t0:.1f} s")
    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="smoke_eval_", dir=root))
    paths, answers = {}, {}
    try:
        data_file, video_dir = write_eval_data(tmp)
        for serving, kernels in (("static", EVAL_STATIC_KERNELS),
                                 ("continuous", EVAL_CONTINUOUS_KERNELS)):
            proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size),
                               cfg, device=device)
            engine = RecordingEngine(QwenEngine(cfg, params, proc))
            out_dir = tmp / f"out_{serving}"
            ecfg = EvalConfig(
                task="LongVideoBench", data_file=data_file,
                video_dir=video_dir, output_dir=str(out_dir), num_frames=32,
                fps=1, prompt_type="thinking",
                max_new_tokens=EVAL_NEW_TOKENS, temperature=0.0,
                batch_size=2, serving=serving)
            probe = DecodeProbe() if serving == "static" else SliceProbe()
            gc.collect()
            torch.cuda.empty_cache()
            reset_launch_counts()
            with probe:
                t0 = time.perf_counter()
                metrics = run_benchmark(ecfg, engine)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = launch_counts()
            docs = read_jsonl(str(out_dir / "LongVideoBench_results.jsonl"))
            answers[serving] = {d["id"]: d["predicted_answer"] for d in docs}
            lengths = engine.lengths if serving == "static" else probe.lengths
            grids = {g for p in engine.prompts for g in p[0]}
            buckets = {-(-p[1] // 512) * 512 for p in engine.prompts}
            pads = [[EVAL_PROMPT_BUCKET - n for n in p[2]]
                    for p in engine.prompts]
            tag = f"eval[{serving}]"
            log(f"{tag}: {len(docs)} records, wall {wall:.2f} s (video "
                f"decode, preprocess, ViT, prefill, decode and scoring), "
                f"{sum(lengths)} tokens generated, {sum(lengths) / wall:.1f} "
                f"tok/s | lengths {lengths} | grids {sorted(grids)} | buckets "
                f"{sorted(buckets)} | left padding {pads} | metrics "
                f"{json.dumps(metrics, default=float)}")
            if serving == "static":
                log(f"{tag}: {probe.logit_steps} sampled steps, "
                    f"{probe.nonfinite} with non-finite logits | decode ms "
                    f"per step median {_median(probe.decode_ms()):.2f} over "
                    f"{len(probe.decode_ms())} unchecked steps | K2 vs "
                    f"plain on live inputs: {len(probe.k2_err)} calls at "
                    f"(q shape, P, T) {sorted(probe.k2_shapes)}, max_abs_err "
                    f"{max(probe.k2_err, default=float('nan')):.3e}, "
                    f"{probe.k2_bad} outside")
                if not probe.k2_err or probe.k2_bad:
                    raise RuntimeError(
                        f"K2 disagrees with its plain version on "
                        f"{probe.k2_bad} of {len(probe.k2_err)} live calls")
                if [tuple(p) for p in pads[:1]] != [EVAL_PROMPT_PADS]:
                    raise RuntimeError(f"first static batch padded {pads[0]}: "
                                       f"phase 3 checked K2 at "
                                       f"{EVAL_PROMPT_PADS}")
            else:
                log(f"{tag}: ViT encode ms {[round(x, 2) for x in probe.vit_ms]}"
                    f" | prefill ms per admission "
                    f"{[round(x, 2) for x in probe.prefill_ms]} | decode ms "
                    f"per step median {_median(probe.decode_ms):.2f} over "
                    f"{len(probe.decode_ms)} steps")
            log(f"{tag}: launches {counts}")
            if engine.errors:
                raise RuntimeError(f"{tag}: the engine raised "
                                   f"{len(engine.errors)} times; first:\n"
                                   f"{engine.errors[0]}")
            if len(docs) != 4 or len(lengths) != 4 or min(lengths) < 1:
                raise RuntimeError(f"{tag}: {len(docs)} records, completion "
                                   f"lengths {lengths}")
            if probe.nonfinite:
                raise RuntimeError(f"{tag}: {probe.nonfinite} non-finite "
                                   "logits tensors")
            if not LVB_METRICS <= set(metrics):
                raise RuntimeError(f"{tag}: metrics {sorted(metrics)}")
            if grids != {EVAL_GRID} or buckets != {EVAL_PROMPT_BUCKET}:
                raise RuntimeError(f"{tag}: grids {grids} buckets {buckets}, "
                                   f"expected {EVAL_GRID} {EVAL_PROMPT_BUCKET}")
            if min(counts[k] for k in kernels) < 1:
                raise RuntimeError(f"{tag}: a kernel of the path was never "
                                   f"launched: {counts}")
            paths[f"eval {serving}"] = counts
            probe.logits = None
            del engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # with decode_quant, serving="static" quantizes the decode weights on
    # every QwenEngine.generate call (as the JAX sampler does): its cost
    requant = {}
    for quant in ("int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qmodel = quantize_decode_model(params["model"], quant)
        torch.cuda.synchronize()
        requant[quant] = time.perf_counter() - t0
        del qmodel
    log("eval: weight quantization per static generate call with "
        "decode_quant int8 / int4: "
        + " / ".join(f"{v:.3f} s" for v in requant.values()))
    same, agree = 0, []
    for i, text in answers["static"].items():
        a, b = text.split(), answers["continuous"][i].split()
        same += a == b
        agree.append(sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1))
    log(f"eval static vs continuous: {same} of {len(agree)} answers "
        f"identical, {statistics.mean(agree):.4f} of the tokens agree "
        f"position by position (not gated)")
    return paths


SERVE_KERNELS = ("K1", "K3", "K4", "K5")
SERVE_INT4_KV_KERNELS = ("K1", "K3", "K4", "K5-int8", "K6")
TRAIN_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K2-int8", "K3", "K4")
ROLLOUT_BF16_KERNELS = ("K1", "K2", "K3", "K4")
EVAL_STATIC_KERNELS = ("K1", "K2", "K3", "K4")
EVAL_CONTINUOUS_KERNELS = ("K1", "K3", "K4", "K5")

# the measured fields of each kernel in the kernels line
LINE_FIELDS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")

SOURCES = {
    "K1": ("flash_attention", "spacer_tpu_torch/csrc/flash_attention.cu",
           "spacer_tpu/ops/flash_attention.py:452"),
    "K1-bwd dq": ("flash_attention_bwd_dq",
                  "spacer_tpu_torch/csrc/flash_attention_bwd.cu",
                  "spacer_tpu/ops/flash_attention.py:368"),
    "K1-bwd dkv": ("flash_attention_bwd_dkv",
                   "spacer_tpu_torch/csrc/flash_attention_bwd.cu",
                   "spacer_tpu/ops/flash_attention.py:413"),
    "K2": ("flash_decode_attention",
           "spacer_tpu_torch/csrc/flash_decode_grouped.cu",
           "spacer_tpu/ops/flash_decode.py:215"),
    "K2-int8": ("flash_decode_attention_int8",
                "spacer_tpu_torch/csrc/flash_decode_grouped.cu",
                "spacer_tpu/ops/flash_decode.py:215"),
    "K3": ("window_attention_hsd", "spacer_tpu_torch/csrc/vit_window_attention.cu",
           "spacer_tpu/ops/vit_window_attention.py:116"),
    "K4": ("chunk_attention_hsd", "spacer_tpu_torch/csrc/vit_chunk_attention.cu",
           "spacer_tpu/ops/vit_window_attention.py:187"),
    "K5": ("flash_ragged_decode_attention", "spacer_tpu_torch/csrc/flash_decode.cu",
           "spacer_tpu/ops/flash_decode.py:398"),
    "K5-int8": ("flash_ragged_decode_attention_int8",
                "spacer_tpu_torch/csrc/flash_decode.cu",
                "spacer_tpu/ops/flash_decode.py:398"),
    "K6": ("int4_matmul (dense_q4)", "spacer_tpu_torch/csrc/int4_matmul.cu",
           "spacer_tpu/ops/int4_matmul.py:112"),
}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = device_facts()
    build_kernels()
    results = check_kernels()
    results.update(check_training_kernels())
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    paths = serve_slice(QWEN25_VL_7B)
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=TRAIN_LM_LAYERS))
    paths.update(train_slice(train_cfg))
    gc.collect()
    torch.cuda.empty_cache()
    checkpoint_phase()
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(eval_slice(QWEN25_VL_7B))
    counts = {k: sum(c[k] for c in paths.values()) for k in SOURCES}
    log("launches per path: " + json.dumps(paths))
    kernels = [{"name": SOURCES[k][0], "route": "cuda", "source": SOURCES[k][1],
                "replaces": SOURCES[k][2], "launches": counts[k],
                **{f: results[k][f] for f in LINE_FIELDS}}
               for k in SOURCES]
    log(smi)   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
