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
  4c. the OpenAI-compatible HTTP server (serving/server.py) on phase 4's
     params: 3 video + 3 text requests at once through 4 slots (refill), one
     streamed over SSE, one to /v1/completions; every status 200, the
     streamed deltas equal to the request's final text, a clean shutdown,
     K1 / K3 / K4 / K5 launched; TTFT and wall per request;
  4d. speculative serving (speculate_k = SPEC_K), bf16 and int4_kv: the
     forced-draft check (the block step fed the sequential path's own
     greedy tokens as drafts: every block position's logits within
     BF16_TOL * (1 + |x|) of the sequential K5 step's, and every draft with
     a clear top-2 margin accepted; K6 at M = R * kb under int4_kv), then
     generate_many with and without speculation: acceptance, ms per block
     step against ms per ring step, tok/s;
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
     path launched; then the first update's batch again under remat True,
     "dots_narrow" and "dots_mixed:4" (REMAT_MODES): equal loss and
     gradients, each mode's seconds and peak memory, K1 recomputed in
     every mode;
  5b. one bf16 rollout (decode_quant=None) of phase 5's first batch with
     the trained params, its K2 calls held against the plain version live;
  5c. speculative rollouts of that batch at int8_kv and bf16: the
     forced-draft check of the grouped block step against the K2 / K2-int8
     sequential steps, then Sampler.generate with and without speculation
     (acceptance, seconds);
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
     the harness turns into empty answers, are recorded and fail the phase;
  8. SG-RLVR at full Qwen2.5-VL-7B depth (28 LM layers, 8.29 B params):
     two training_step calls with gradient_accumulation_steps=2 make one
     optimizer step, int8 moments and the bf16 accumulator offloaded to
     host memory, two videos of unequal frame size in one rollout (mixed
     grids: one K4 call per grid), int8_kv rollouts (K2-int8 held against
     its plain version live); params bitwise unchanged after call 1, moved
     after call 2, every gradient finite and nonzero, the first update
     replayed with plain attention on a subset of tensors (two full
     gradient sets do not fit), the peaks of the rollout, the backward and
     the optimizer apply, the seconds of each part, the offload copies;
  8b. one LoRA step (make_lora_grpo_train_step) on phase 8's first update
     batch: the base bitwise unchanged, the adapters' gradients as the
     math says (b nonzero, a zero: b starts at zero);
  9. two SFT steps at full depth with int8 moments, replayed likewise;
  10. Qwen2-VL-7B at full geometry (32 full-attention ViT blocks): the ViT
     on two videos of unequal grids (K4 per grid, held against its plain
     version live; embeddings against the plain-attention ViT), then
     generate_many on 2 video + 2 text requests (K1, K4, K5);
  11a. Aria at full ARIA_25B geometry (25.3 B params, random bf16 weights):
     one 720x1280 image through the AriaProcessor and Sampler.generate
     (K1 at head_dim 72 in the 27-layer tower and the projector, K1 at the
     prefill, K2 at group 1), then 4 text requests through generate_many,
     bf16 (K5) and int4_kv (K5-int8, K6); each run replayed through the
     plain versions with its own tokens, every sampled step's logits at
     cosine >= SLICE_COS_TOL; the MoE layer's ms at decode;
  11b. the GRPO trainer with Aria at full widths, the LM cut to 4 of 28
     layers: one image row, G = 8, int8_kv rollouts (K2-int8 held live),
     two optimizer steps (K1 / K1-bwd at group 1, K1 / K1-bwd at 72 in the
     tower, the MoE's grouped backward); the first update replayed with
     plain attention on LM layer 0, tower layer 0 and the projector.
  12. the data x fsdp path (spacer_tpu_torch/parallel) at world 1 over
     NCCL, set up by parallel.multihost.initialize() from torchrun's
     environment for rank 0 of 1: two SGRLVRTrainer steps at 7B widths
     with the LM cut to FSDP_LM_LAYERS layers (phase 5's row, G and
     int8_kv rollouts), unsharded, then over create_mesh({"data": 1,
     "fsdp": 1, "tp": 1}) and shard_params on the same params, rows and
     seed: completions, losses, every update's gradients, the final params
     and int8 moments bitwise equal (grad_norm within rel 1e-6, the params
     within one bf16 ulp where the clip scaled a step and the norms
     differ), every collective counted (calls, bytes, CUDA-event ms), s per
     step and peaks of both; then a torchrun launch of train_sg_rlvr
     (--multihost true) for one step at the tiny config.  `--phases 12
     --world N` runs it over N cards at full depth instead (a development
     run on a host with N cards; the default run needs one).
  13. tensor parallelism (spacer_tpu_torch/parallel/tp.py) at world 1 over
     NCCL: the Qwen2.5-VL-7B widths with the LM cut to TP_LM_LAYERS, each
     once unsharded and once over create_mesh({"data": 1, "fsdp": 1,
     "tp": 1}) with shard_params' tp plan (the tp code paths: local heads,
     the conjugate operations, the vocab-parallel embedding and logps, every
     tp collective counted and none issued): phase 4's requests through
     generate_many at bf16 and int4_kv and one static generate, tokens and
     every sampled step's logits bitwise equal; two SG-RLVR steps under
     phase 12's gate; then a torchrun launch of cli/serve.py (--multihost
     true --tp 1) on a jsonl file at the tiny config.  `--phases 13
     --world 2,4` runs it at full depth over tp = 2 and 4 cards instead.
  14. expert parallelism (spacer_tpu_torch/parallel/expert.py) and Aria's
     tensor parallelism at world 1 over NCCL: ARIA_25B widths with the LM
     cut to ARIA_EP_LM_LAYERS, moe_impl "ep": phase 11's text requests
     through generate_many (bf16, int4_kv) and its image through
     Sampler.generate, unsharded; under "ragged" with the ep run's tokens
     and routes forced (logits cosine >= SLICE_COS_TOL, the capacity's
     drops reported); over create_mesh({"data": 1, "fsdp": 1, "tp": 1})
     with the Aria tp plan and the experts placed by expert (tokens and
     logits bitwise equal, the ep and tp collectives counted and none
     issued); two GRPO steps unsharded and over the mesh under phase 12's
     gate.  `--phases 14 --world 2,4` runs full-depth serving over tp 2 and
     4 and GRPO steps over (1, 2, 2) and (1, 4, 1) instead.
  15. ring attention (spacer_tpu_torch/ops/ring_attention.py) and the
     pipeline (spacer_tpu_torch/parallel/pipeline.py) at world 1 over NCCL:
     Qwen2.5-VL-7B widths with the LM cut to PP_LM_LAYERS, two GRPO steps
     on TRAIN_G packed rows of phase 5's shapes, plain, with the ring tuple
     over create_mesh({"fsdp": 1}) and with pipeline (mesh, 1) over
     create_mesh({"pipe": 1}) (both bitwise equal to the plain step), and
     with pipeline (mesh, 2) (loss and gradient cosines within
     PP_LOSS_RTOL / PP_COS_TOL); the collectives counted and none issued;
     one SFT step through the pipeline.  `--phases 15 --world 2,4` runs
     the ring over 2 and 4 cards and the pipeline over 2 and 4 stages and
     pipe 2 x data 2 at full depth against a one-card reference instead.
  16. the ring through the Qwen ViTs and experts placed over data at world
     1 over NCCL: K1 at head_dim 80 and K1-bwd at 80 and 72 against their
     plain versions (the tower's frame chunks as the ring's blocks, Aria's
     tower); a GRPO loss-and-gradients step at Qwen2.5-VL-7B widths (the
     whole 32-block ViT, PP_LM_LAYERS LM layers) on a video's packed rows
     with the ring tuple against the K4 path (loss, gradient cosines, no
     K4 launch); phase 14's two Aria GRPO steps with moe_ep_axis "data"
     bitwise the fsdp-placed ones.  `--phases 16 --world 2,4` runs Aria's
     step with the experts over data (2, 1, 1) and data x fsdp (2, 2, 1),
     a speculative 7B rollout over rows split over 2 and 4 cards against
     one card, and the ViT ring over 2 and 4 cards at full depth against
     one card instead.
  17. Aria's capacity MoE (moe_impl "ep") under ring attention and the
     pipeline at world 1 over NCCL: ARIA_25B widths with the LM cut to
     PP_LM_LAYERS at the configured capacity factor, phase 15's two GRPO
     steps on its packed rows: plain, with the ring tuple over
     create_mesh({"fsdp": 1}) and with pipeline (mesh, 1) (both bitwise
     the plain step, drops included: the MoE takes capacity over the whole
     batch), and with pipeline (mesh, 2) against the plain step run on
     each microbatch's rows as its own lm_forward call (each MoE call's
     capacity a microbatch's, as JAX's stage body takes it): drops by
     layer equal, loss and gradient cosines within PP_LOSS_RTOL /
     PP_COS_TOL; the dropped assignments printed (the phase fails if none
     dropped), the collectives counted and none issued.  `--phases 17
     --world 2,4` runs the ring over 2 and 4 cards and the pipeline over 2
     and 4 stages and pipe 2 x data 2 at ARIA_PP_WORLD_LAYERS layers
     against one card running the same tokens through every MoE call.
  18. the entry points the port gained last: (a) models.qwen25_vl.forward
     at full Qwen2.5-VL-7B geometry, a video and a text prompt prefilled
     into make_kv_cache (bitwise encode_vision + merge_vision_embeds +
     lm_forward) and API_DECODE_STEPS greedy cached steps (cosine >=
     SLICE_COS_TOL against a no-cache forward at API_CHECK_STEPS; K1, K3,
     K4); then at 7B widths with the LM cut to PP_LM_LAYERS, at world 1
     over NCCL: K1 and K1-bwd at causal=0 against their plain versions
     and SDPA; (b) lm_forward(causal=False) forward and backward, kernels
     against plain attention (logits and every gradient at cosine >=
     GRAD_COS_TOL), and through the pipeline at pipe 1 bitwise; (c)
     lm_decode_step bitwise lm_decode_step_split, bf16 and int8 caches (K2,
     K2-int8); (d) window_attention on K3 against its plain version,
     forward and gradients; (e) save_model_only -> load_model_only
     bitwise, GB/s; (f) the LoRA GRPO step with the ring attn_impl
     bitwise the plain LoRA step.
Phase 3 also checks the kernels at the Aria path's shapes (3c: K1 at
head_dim 72, K1 / K1-bwd / K2 / K2-int8 / K5 / K5-int8 at group 1), 3d at
the shapes one rank of a tp-2 or tp-4 Qwen2.5-VL-7B runs (14 / 7 query
heads, 2 / 1 KV heads, 8 / 4 ViT heads, K6 at the sliced products), and 3e
at an Aria tp-2 or tp-4 rank's (8 / 4 tower heads at head_dim 72, 10 / 5
LM heads at group 1, K6 at the sliced products, K = 832 included), and 3f
K1 and K1-bwd as ring attention calls them (blocks of an 8192-token row
over 4 emulated shards, the backward with the merged LSE and delta), at
Qwen2.5-VL-7B's heads and at Aria's LM heads (20 and 20 of 128).
The line before the last is a JSON object describing the kernels (launches
summed over the paths of phases 4-5c and 7-18, each counted from 0 just
before it runs; the head_dim 80 / 72 instantiations of K1 and K1-bwd also
apart, their launches inside their kernel's); the last line is {"ok":
true, "device": {...}}.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 12 --world 4   # fsdp over four cards
    python3 chip_smoke.py --phases 13 --world 2,4   # tp over 2, then 4
    python3 chip_smoke.py --phases 14 --world 2,4   # Aria tp 2, 4; ep 4
    python3 chip_smoke.py --phases 15 --world 2,4   # ring / pipe, 2 and 4
    python3 chip_smoke.py --phases 16 --world 2,4   # ep over data, split
                                                    # speculation, ViT ring
    python3 chip_smoke.py --phases 17 --world 2,4   # Aria ep: ring / pipe
    python3 chip_smoke.py --phases 18        # the last entry points alone
    python3 chip_smoke.py --phases 4c,4d     # a development run of some
"""

from __future__ import annotations

import collections
import contextlib
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
# Phase 5's addition: phase 5's first update again under these remat modes
# (loss within REMAT_LOSS_RTOL of remat=True's, per-group gradient cosine
# >= REMAT_COS_TOL: the same math recomputed, bf16 sums in other orders).
REMAT_MODES = (True, "dots_narrow", "dots_mixed:4")
REMAT_LOSS_RTOL, REMAT_COS_TOL = 1e-3, 0.999
# Phase 8, SG-RLVR at full depth (all 28 LM layers): two video rows of
# unequal frame size in one rollout (16 frames of 360x640 -> grid
# (8, 16, 30), chunks of 480 patches, and 16 of 240x320 -> (8, 18, 22),
# chunks of 396: one ViT call over mixed grids), prompts of 1069 and 901
# tokens left-padded in the 1536 bucket by FULL_PROMPT_PADS.  (Worked out
# on the CPU: the processor is deterministic.)  Phase 3 times K4 at the
# second grid's chunks.
FULL_VIDEOS = ((16, 360, 640), (16, 240, 320))
FULL_GRIDS = ((8, 16, 30), (8, 18, 22))
FULL_PROMPT_PADS = (467, 635)
FULL_ACCUM_STEPS = 2
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
# lm_head; M = the serving slots (4), the rollout's B*G rows (16) and the
# speculative block step's R * kb rows at 4 and 8 slots (20, 40)
K6_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
             (3584, 152064))
K6_ROWS = (4, 16, 20, 40)
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
# The phases in the order they run (main's --phases selects some of them)
PHASES = ("3", "3d", "3e", "3f", "4", "4c", "4d", "5", "5c", "6", "7", "8",
          "9", "10", "11", "12", "13", "14", "15", "16", "17", "18")
# Phase 4c, the HTTP server: HTTP_VIDEOS video requests over mp4 files of
# HTTP_VIDEO_SECONDS at HTTP_VIDEO_FPS (16 frames sampled at 2 fps, grid
# (8, 16, 30) as phase 4's) and as many text requests, through HTTP_SLOTS
# slots of one HTTP_PROMPT_LEN prompt bucket.
HTTP_SLOTS, HTTP_PROMPT_LEN, HTTP_VIDEOS = 4, 1024, 3
HTTP_VIDEO_SECONDS, HTTP_VIDEO_FPS = 8, 4
# Phases 4d and 5c, speculative decoding: SPEC_K drafts per block (kb = 5
# tokens per row and step); the forced-draft checks take SPEC_CHECK_STEPS
# block steps.  Their gate: every block position's logits within cosine
# SPEC_COS_TOL of the sequential step's, and every draft accepted whose
# sequential top-2 margin exceeds BF16_TOL * (1 + |x|); the elementwise
# BF16_TOL * (1 + |x|) is reported, not gated: at 28 bf16 layers either
# difference between the paths alone (the attention's reduction order, or
# the GEMMs' row count: R * kb rows against R) puts ~1.5 % of the logits
# of random weights outside it (control_stats; PERF.md section 6).
SPEC_K, SPEC_CHECK_STEPS = 4, 8
SPEC_COS_TOL = 0.999
# Phase 10, Qwen2-VL-7B: two 16-frame videos of unequal frame size (grids
# (8, 16, 30) and (8, 20, 28) through the serving processor: chunks of 480
# and 560 patches, one K4 call per grid in each of the 32 full-attention
# blocks).  (Worked out on the CPU: the processor is deterministic.)
QWEN2_VIDEOS = ((16, 360, 640), (16, 240, 320))
QWEN2_GRIDS = ((8, 16, 30), (8, 20, 28))
# K4 at the Qwen2-VL ViT's other chunks: the second video's (560), and an
# image's, an image being one chunk of all its patches: 448x448 (grid
# (1, 32, 32)) and 1008x1008 ((1, 72, 72))
K4_QWEN2_CHUNKS = ((8 * 560, 560), (32 * 32, 32 * 32), (72 * 72, 72 * 72))
# Phase 11, Aria (ARIA_25B): a synthetic ARIA_IMAGE_HW image is one
# 980-pixel crop of 4900 patches whose resized 551 x 980 pixels leave 40 of
# 70 patch rows live (ARIA_VALID_PATCHES keys), ARIA_QUERIES projector
# queries; the image rollout and the text serving decode ARIA_NEW_TOKENS.
# Phase 11b trains the LM cut to ARIA_TRAIN_LM_LAYERS layers on that image
# (a 270-token prompt, left-padded in the trainer's 512 bucket by
# ARIA_TRAIN_PROMPT_PAD), ARIA_TRAIN_G completions of up to
# ARIA_TRAIN_NEW_TOKENS.  (Worked out on the CPU: the processor is
# deterministic.)  Phase 3c checks the kernels at these shapes.
ARIA_IMAGE_HW = (720, 1280)
ARIA_VALID_PATCHES, ARIA_QUERIES = 40 * 70, 256
ARIA_NEW_TOKENS = 32
# The image generate's 270-token prompt, left-padded in the sampler's
# 128-token length bucket (K2 at G = 1, group_q 1 there)
ARIA_IMAGE_PROMPT_BUCKET, ARIA_IMAGE_PROMPT_PAD = 384, 384 - 270
# K6 at Aria's int4 decode products (phase 11a's int4_kv serving, M = its 4
# slots): q/k/v/o 2560 -> 2560, the shared experts' gate/up 2560 -> 3328
# and down 3328 -> 2560, lm_head 2560 -> 100352
ARIA_K6_SHAPES = ((2560, 2560), (2560, 3328), (3328, 2560), (2560, 100352))
ARIA_TRAIN_LM_LAYERS = 4
ARIA_TRAIN_PROMPT_BUCKET, ARIA_TRAIN_PROMPT_PAD = 512, 512 - 270
ARIA_TRAIN_G, ARIA_TRAIN_NEW_TOKENS = 8, 128
# Phases 3d and 13: the tensor-parallel sizes whose per-rank shapes phase 3d
# holds every kernel at (the 7B's 4 KV heads allow 2 and 4)
TP_SIZES = (2, 4)
# Phase 13 at world 1 (tp 1): the LM cut to TP_LM_LAYERS layers (the ViT
# whole); its two SG-RLVR steps run TP_TRAIN_G completions of up to
# TP_TRAIN_NEW_TOKENS tokens on one TP_TRAIN_VIDEO row
TP_LM_LAYERS = 4
TP_TRAIN_G, TP_TRAIN_NEW_TOKENS = 4, 64
TP_TRAIN_VIDEO = (16, 360, 640)
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
    from spacer_tpu_torch.parallel.offload import mem_available_bytes

    avail = mem_available_bytes()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"host MemAvailable "
        f"{'not readable' if avail is None else f'{avail / 1e9:.2f} GB'}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{[l for l in nvcc.splitlines() if 'release' in l][0].strip()} | "
        f"cv2 {cv2.__version__} | PIL {PIL.__version__}")
    return smi


# the functions main runs the phases through, each timed (time_phases)
PHASE_FUNCTIONS = (
    "device_facts", "build_kernels", "check_kernels", "check_training_kernels",
    "check_aria_kernels", "check_tp_kernels", "check_aria_tp_kernels",
    "check_ring_kernels", "check_vit_ring_kernels", "serve_slice",
    "train_slice", "checkpoint_phase", "eval_slice", "full_train_slice",
    "lora_phase", "sft_phase", "qwen2_vl_phase", "aria_serve_phase",
    "aria_train_phase", "fsdp_phase", "tp_phase", "aria_ep_phase",
    "ring_pipe_phase", "vit_ring_phase", "aria_ring_pipe_phase",
    "api_phase")


def time_phases(namespace: dict) -> dict:
    """Wraps each of PHASE_FUNCTIONS that `namespace` (a chip_smoke
    module's globals, this one's or an older checkout's) defines in a
    wall-clock timer -> {name: seconds}, filled in as they run."""
    import functools

    seconds = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds[name] = (seconds.get(name, 0.0)
                                 + time.perf_counter() - t)
        return run

    for name in PHASE_FUNCTIONS:
        if name in namespace:
            namespace[name] = timed(name, namespace[name])
    return seconds


def phase_seconds_line(seconds: dict, total: float) -> str:
    return "phase seconds: " + json.dumps(
        {"total": round(total, 2), **{k: round(v, 2)
                                      for k, v in seconds.items()}})


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

    # K3 / K4: ViT at grid (8, 16, 30): 16 heads, head_dim 80; K4 at the
    # ViT's chunks (the kernels line) and at 8 chunks of 252 = 18 x 14
    # patches (a 252x196 frame pair), no multiple of the kernel's 64-key
    # tiles, and at the Qwen2-VL ViT's other chunks (K4_QWEN2_CHUNKS; its
    # first video's chunk is the ViT's 480)
    vcfg = QWEN25_VL_7B.vision
    layout = vision_layout([(8, 16, 30)], vcfg)
    mixed = vision_layout([FULL_GRIDS[1]], vcfg)
    results.update(check_vit_kernels(
        randn, dev, layout, vcfg.num_heads, vcfg.head_dim,
        (("K4", layout.seq_len, layout.full_chunk),
         ("K4 wt=252", 8 * 252, 252),
         ("K4 mixed", mixed.seq_len, mixed.full_chunk),
         *((f"K4 qwen2 wt={c}", S, c) for S, c in K4_QWEN2_CHUNKS))))
    results.update(check_int4_matmul(gen))
    dense_q8_cost(gen)
    return results


def check_vit_kernels(randn, dev, layout, Hv, Dv, k4_cases, tag="") -> dict:
    """K3 on the windows of `layout` and K4 at each (result key, tokens,
    chunk) of `k4_cases`, Hv heads of Dv, against their plain versions
    (results "K3" + tag and the cases' keys)."""
    from spacer_tpu_torch.ops import vit_window_attention as vwa

    n_win, wt = layout.win_gather.shape
    scale = Dv ** -0.5
    qw, kw3, vw = (randn(Hv, n_win * wt, Dv) for _ in range(3))
    lengths = np.asarray(layout.win_valid.sum(1))
    bias = torch.from_numpy(vwa.validity_bias(lengths, wt)).to(dev)
    win_mask = (bias == 0).view(1, n_win, 1, wt)

    def windows(x, n, w):
        return x.view(Hv, n, w, Dv)

    results = {}
    results["K3" + tag] = compare(
        f"K3 window_attention_hsd ({Hv}, {n_win * wt}, {Dv}) wt={wt}{tag}",
        lambda: vwa.window_attention_hsd(qw, kw3, vw, bias, wt, scale),
        lambda: vwa.window_attention_reference(qw, kw3, vw, bias, wt, scale),
        work=(4 * Hv * int(lengths.sum()) * Dv * 2 + n_win * wt * 4,
              4 * Dv * Hv * int((lengths.astype(np.int64) ** 2).sum())),
        library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(
            *(windows(x, n_win, wt) for x in (qw, kw3, vw)),
            attn_mask=win_mask, scale=scale))
    for key, S, chunk in k4_cases:
        qc, kc, vc = (randn(Hv, S, Dv) for _ in range(3))
        results[key] = compare(
            f"K4 chunk_attention_hsd ({Hv}, {S}, {Dv}) wt={chunk}{tag}",
            lambda: vwa.chunk_attention_hsd(qc, kc, vc, chunk, scale),
            lambda: vwa.chunk_attention_reference(qc, kc, vc, chunk, scale),
            work=(4 * Hv * S * Dv * 2, 4 * Dv * Hv * S * chunk),
            library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(
                *(windows(x, S // chunk, chunk) for x in (qc, kc, vc)),
                scale=scale))
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


def ragged_decode_case(randn, gen, P, C, plen, tlen, admit, Hkv=4, gq=7):
    """K5's inputs on R = len(plen) slot rows of Hkv kv heads and gq query
    heads each: row r's prefix live in its last plen[r] of P keys, its ring
    window the tlen[r] positions from ring index admit[r] on (mod C); bf16
    caches for K5, int8 codes + f32 scales of the same values for K5-int8.
    -> ({kernel id: args}, kwargs, live rows, {kernel id: (bytes, bf16
    operations)})."""
    from spacer_tpu_torch.ops import flash_decode as fd

    dev = gen.device
    R, D = len(plen), 128
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


def check_ragged_decode(randn, gen, tag, P, C, plen, tlen, admit, Hkv=4,
                        gq=7) -> dict:
    """Phase 3, K5 and K5-int8 (results "K5" + tag, "K5-int8" + tag) on
    ragged_decode_case's inputs.  Live rows are held against the plain
    version; rows with no live key must come out exactly 0 (the plain
    version's mean of V there is discarded by every caller)."""
    from spacer_tpu_torch.ops import flash_decode as fd

    cases, dkw, live, work = ragged_decode_case(randn, gen, P, C, plen, tlen,
                                                admit, Hkv, gq)
    results = {}
    for kid, args in cases.items():
        out = fd.flash_ragged_decode_attention(*args, **dkw)
        if not bool(torch.isfinite(out).all()) or bool(out[~live].any()):
            raise RuntimeError(f"{kid}{tag}: non-finite values, or nonzero "
                               "rows for slots with no live key")
        results[kid + tag] = compare(
            f"{kid} flash_ragged_decode_attention R={len(plen)} Pmax={P} "
            f"Cmax={C} Hkv={Hkv} gq={gq} ({int(live.sum())} live slots)",
            lambda: fd.flash_ragged_decode_attention(*args, **dkw),
            lambda: fd.ragged_decode_attention_reference(*args, **dkw),
            lambda x: x[live], work=work[kid])
    return results


def check_int4_matmul(gen, shapes=K6_SHAPES, rows=K6_ROWS, tag="",
                      fused_only=False) -> dict:
    """Phase 3, K6: every (K, N) of `shapes` (the 7B int4 decode's by
    default) at each M of `rows` (by default K6_ROWS: serving slots,
    rollout rows, speculative blocks), against its plain version: the
    scale-free
    product (int4_matmul) within the f32 summation-order bound K6_SUM_TOL *
    sum |terms|, and dense_q4 (one launch: row scale, product, column
    scale, cast, bias) within that bound times the column scale plus one
    bf16 ulp at each of its two roundings.  Yardsticks: torch's
    _weight_int4pack_mm (tinygemm; the same codes + 8 as unsigned nibbles,
    group size 128, zero 0, scale 1 for the scale-free product and the
    column scale for dense_q4, repacked once outside the timing) and the
    bf16 torch.matmul on the widened weight, which the port never calls.
    `fused_only`: dense_q4 alone (the call the decode path makes)."""
    from spacer_tpu_torch.ops import int4_matmul as im
    from spacer_tpu_torch.ops import quant

    dev = gen.device
    results = {}
    for K, N in shapes:
        codes, params = int4_dense_case(gen, K, N)
        packed = params["kernel_q4"]
        row_scale, col_scale = params["q4_row_scale"], params["q4_col_scale"]
        tinygemm = int4pack_yardstick(codes, col_scale)
        w_bf16 = codes.to(torch.bfloat16)
        for M in rows:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            allowed = (K6_SUM_TOL * (x.float().abs() @ codes.float().abs())
                       + 1e-6)
            q_bytes = K * N // 2 + M * K * 2
            if not fused_only:
                results[f"K6{tag} M={M} K={K} N={N}"] = compare(
                    f"K6 int4_matmul{tag} M={M} K={K} N={N}",
                    lambda: im.int4_matmul(x, packed),
                    lambda: im.int4_matmul_reference(x, packed),
                    allowed=allowed, work=(q_bytes + M * N * 4, 2 * M * K * N),
                    library_fn=tinygemm(x, False))
            xs = (x * row_scale.to(x.dtype)).float()
            ref = quant.dense_q4_reference(params, x)
            allowed = (K6_SUM_TOL * (xs.abs() @ codes.float().abs()) * col_scale
                       + K6_BF16_ULP * (((xs @ codes.float()) * col_scale).abs()
                                        + ref.float().abs()) + 1e-6)
            lib = tinygemm(x, True)
            results[f"K6{tag} dense_q4 M={M} K={K} N={N}"] = compare(
                f"K6 dense_q4 (fused){tag} M={M} K={K} N={N}",
                lambda: quant.dense_q4(params, x),
                lambda: quant.dense_q4_reference(params, x), allowed=allowed,
                work=(q_bytes + K * 4 + N * (4 + 2 + M * 2), 2 * M * K * N),
                library_fn=lib)
            if not fused_only:
                log(f"K6{tag} M={M} K={K} N={N}: bf16 torch.matmul on the "
                    f"widened weight "
                    f"{median_ms(lambda: torch.matmul(x, w_bf16)):.4f} ms")
            del allowed, xs, ref
        del codes, packed, params, tinygemm, w_bf16
        torch.cuda.empty_cache()
    if not tag:
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


def grouped_decode_case(randn, gen, P, pads, G, C=TRAIN_NEW_TOKENS, Hkv=4,
                        gq=7):
    """K2's inputs: len(pads) prompts x G completions of group_q gq (Qwen's
    7 by default), Hkv kv heads, D 128, prefix P left-padded by `pads`,
    tails of C tokens; bf16 caches for K2, int8 codes + f32 scales of the
    same values for K2-int8.  -> (fn(step) -> {kernel id: args}, kwargs,
    fn(step) -> {kernel id: (bytes, bf16 operations)})."""
    from spacer_tpu_torch.ops import flash_decode as fd

    dev = gen.device
    D = 128
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
                         C=TRAIN_NEW_TOKENS, Hkv=4, gq=7):
    """Phase 3b, K2 and K2-int8 on grouped_decode_case's inputs at each live
    step of `steps`, against the plain version (results "K2" / "K2-int8" +
    tag + " P=.. step=..")."""
    from spacer_tpu_torch.ops import flash_decode as fd

    args, dkw, work = grouped_decode_case(randn, gen, P, pads, G, C, Hkv, gq)
    for step in steps:
        a, w = args(step), work(step)
        for kid in ("K2", "K2-int8"):
            results[f"{kid}{tag} P={P} step={step}"] = compare(
                f"{kid} flash_decode_attention{tag} P={P} pads {pads} "
                f"step={step}",
                lambda: fd.flash_decode_attention(*a[kid], **dkw),
                lambda: fd.decode_attention_reference(*a[kid], **dkw),
                work=w[kid])


def check_k1_passes(randn, gen, P, pads, results, H=28, Hkv=4, G=TRAIN_G,
                    C=TRAIN_NEW_TOKENS, suffix=""):
    """K1 and K1-bwd (dq, dk/dv) against their plain versions on an
    update's two attention passes: the prompt pass (len(pads) prompts of P
    keys, left-padded by `pads`) and the completion pass (G completions of
    C tokens per prompt against the prompt's keys and their own), H query
    and Hkv KV heads of 128 (results "K1 <pass><suffix>", "K1-bwd dq ...",
    "K1-bwd dkv ...")."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa

    dev, D = gen.device, 128
    mask = torch.ones((len(pads), P), dtype=torch.bool, device=dev)
    for b, pad in enumerate(pads):
        mask[b, :pad] = False
    # prompt pass: B prompts, Sq=Skv=P; the padded query rows get no
    # output gradient (nothing downstream reads them)
    B = len(pads)
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
            (f"prompt B={B} S={P}{suffix}", (q, k, v, dout, prompt),
             shapes["prompt"]),
            (f"completion N={N} Sq={C} Skv={P + C}{suffix}",
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



def check_training_kernels(device="cuda") -> dict:
    """Phase 3b: K1, K1-bwd (dq, dk/dv) and K2 against their plain versions, at
    the training slice's shapes (prompt bucket TRAIN_PROMPT_BUCKET, padding
    TRAIN_PROMPT_PAD: one prompt in the update, it and its temporal shuffle
    in the rollout; these results go into the kernels line) and at a
    two-prompt batch (P=1024, one prompt padded by 300), which the slice's
    single row leaves out: a batch index past 0 and rows of differing
    padding."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    results = {}
    G, C = TRAIN_G, TRAIN_NEW_TOKENS
    path_P, path_pad = TRAIN_PROMPT_BUCKET, TRAIN_PROMPT_PAD
    # (P, padding of the update's prompts, of the rollout's prompts, steps)
    for P, pads, k2_pads, steps in (
            (path_P, (path_pad,), (path_pad, path_pad), (1, 100, C - 1)),
            (1024, (0, 300), (0, 300), (1, 100, C))):
        check_k1_passes(randn, gen, P, pads, results)
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
        # host clock: (start, end) of every decode step, and per admitted
        # request the end of the admission that sampled its first token
        self.spans, self.admitted = [], []
        self._saved = (bm.prologue, bm.lm_forward, bm.ragged_decode_step,
                       bm.sample_logits, bm.ContinuousBatcher.poll_finished,
                       bm.ContinuousBatcher.admit)

    def _timed(self, sink, fn, check_logits, spans=None):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if sink is not None:
                sink.append((t1 - t0) * 1e3)
            if spans is not None:
                spans.append((t0, t1))
            logits = out[0] if isinstance(out, tuple) else out
            if check_logits and not bool(torch.isfinite(logits).all()):
                self.nonfinite += 1
            return out
        return wrapped

    def __enter__(self):
        bm = self.bm
        prologue, lm_forward, step, sample, poll, admit = self._saved

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

        def timed_admit(batcher, admissions):
            admit(batcher, admissions)
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.admitted += [now] * len(admissions)

        timed_prefill = self._timed(self.prefill_ms, lm_forward, True)
        timed_step = self._timed(self.decode_ms, step, True, self.spans)

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
        bm.ContinuousBatcher.admit = timed_admit
        return self

    def __exit__(self, *exc):
        (self.bm.prologue, self.bm.lm_forward, self.bm.ragged_decode_step,
         self.bm.sample_logits, self.bm.ContinuousBatcher.poll_finished,
         self.bm.ContinuousBatcher.admit) = self._saved

    def decode_gaps_ms(self) -> list:
        """Host time between the end of one decode step and the start of
        the next (sampling, bookkeeping, and between chunks the poll and
        any admission)."""
        return [(b[0] - a[1]) * 1e3 for a, b in zip(self.spans, self.spans[1:])]


class RouteLog:
    """The MoE's expert choices (ops/moe.route_topk, Aria's LM), recorded in
    call order, or with `replay` (an earlier run's) forced: the router's
    logits are this run's own, gathered at the replayed experts.  Top-k is
    discontinuous: bf16 rounding differences between a kernel run and its
    plain replay flip near-tied choices, which moves the logits by whole
    experts and says nothing about the kernels, so a replay takes the
    kernel run's routes as it takes its tokens.  `flips` counts the routes
    this run would have chosen otherwise (reported, not gated).  A model
    without an MoE makes no call: nothing is recorded or replayed."""

    def __init__(self, replay=None):
        import spacer_tpu_torch.ops.moe as moe

        self.moe, self.replay, self.saved = moe, replay, moe.route_topk
        self.idx, self.rows, self.flips = [], 0, 0

    def __enter__(self):
        route = self.saved

        def logged(router_kernel, x, topk):
            scores, idx = route(router_kernel, x, topk)
            if self.replay is not None:
                want = self.replay[len(self.idx)]
                self.flips += int((torch.sort(idx, -1).values
                                   != torch.sort(want, -1).values).any(-1)
                                  .sum())
                logits = torch.matmul(x.float(), router_kernel.float())
                scores, idx = torch.softmax(logits.gather(-1, want), -1), want
            self.idx.append(idx)
            self.rows += idx.shape[0]
            return scores, idx

        self.moe.route_topk = logged
        return self

    def __exit__(self, *exc):
        self.moe.route_topk = self.saved

    def note(self) -> str:
        """The share of routed rows whose expert set the replay overrode.
        Padded prompt rows count too, and differ wholesale: K1 writes 0 for
        a row that sees no key, the plain version the mean of V."""
        return (f" | MoE routes replayed: {self.flips} of {self.rows} "
                f"routed rows ({self.flips / max(self.rows, 1):.4f}, padded "
                f"rows included) would have taken other experts"
                if self.rows else "")


def plain_kernels():
    """For a reference run only: utils.debugging.interpret_kernels, which
    sends every kernel wrapper's call on the card to its plain version (no
    launch, so the launch counts stay the path's) and yields the rerouted
    calls by kernel id."""
    from spacer_tpu_torch.utils.debugging import interpret_kernels

    return interpret_kernels()


def serve_slice(cfg, device="cuda", phases=PHASES) -> dict:
    """Phases 4 and 4b: the serving slice (at full Qwen2.5-VL-7B geometry
    when called from main) with bf16 decode, then with decode_quant=
    "int4_kv"; each run is followed by the same requests with the kernels
    replaced by their plain versions and the run's tokens replayed: the
    logits of every sampled step must agree.  Then, on the same params,
    phases 4c (http_phase) and 4d (spec_serve_phase), each of `phases`
    that is selected.  Returns the launches of each path, {path: {kernel
    id: count}}."""
    params, proc, msgs = serving_setup(cfg, device)
    paths = {}
    if "4" in phases:
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
        paths.update({"serve": counts, "serve int4_kv": counts_q})
    if "4c" in phases:
        paths["http"] = http_phase(cfg, params, proc)
    if "4d" in phases:
        paths.update(spec_serve_phase(cfg, params, proc, msgs))
    return paths


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


def serve_run(cfg, params, proc, msgs, decode_quant, kernels,
              gen_kw=SERVE_GEN_KW, grid=((8, 16, 30),), tag="slice"):
    """One serving path and its plain replay (see serve_slice): the first
    request's vision grid must be `grid`."""
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"{tag}[{decode_quant or 'bf16'}]"
    engine = QwenEngine(cfg, params, proc, decode_quant=decode_quant)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with RouteLog() as routes, SliceProbe() as probe:
        t0 = time.perf_counter()
        texts = engine.generate_many(msgs, **gen_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    got_grid = engine.encode_request(msgs[0])["grid_thw"]
    tokens = sum(probe.lengths)
    log(f"{tag}: {len(texts)} completions, lengths {probe.lengths}, vision "
        f"grid {got_grid}, wall {wall:.2f} s (the batcher's weight "
        f"quantization included), {tokens / wall:.1f} generated tok/s")
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
    if got_grid != grid:
        raise RuntimeError(f"unexpected vision grid {got_grid}")
    if min(counts[k] for k in kernels) < 1:
        raise RuntimeError(f"a kernel of the path was never launched: {counts}")
    del engine

    # reference run: plain versions everywhere, the kernel run's tokens
    # (and MoE routes)
    with plain_kernels(), RouteLog(replay=routes.idx) as ref_routes, \
            SliceProbe(replay=probe.tokens) as ref:
        QwenEngine(cfg, params, proc, decode_quant=decode_quant
                   ).generate_many(msgs, **gen_kw)
    routes = None
    if launch_counts() != counts or len(ref.logits) != len(probe.logits):
        raise RuntimeError("the reference run launched a kernel or took "
                           "other steps")
    cos = torch.stack([torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
                       for a, b in zip(probe.logits, ref.logits)])
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(probe.logits, ref.logits)]).mean()
    log(f"{tag} vs plain versions: logits cosine min {float(cos.min()):.5f} "
        f"median {float(cos.median()):.5f} over {len(cos)} sampled steps "
        f"(tol {SLICE_COS_TOL}) | greedy argmax agreement {float(agree):.4f}"
        + ref_routes.note())
    if not float(cos.min()) >= SLICE_COS_TOL:
        raise RuntimeError("the kernel path's logits disagree with the plain "
                           "versions' path")
    probe.logits = ref.logits = None
    return counts, probe


def write_videos(root: pathlib.Path, prefix: str, n: int, seconds: int,
                 fps: int, seed: int, shift: int) -> list:
    """n 360x640 mp4 files (cv2, mp4v) of `seconds` at `fps`, root/prefix{i}
    .mp4: a random frame from `seed` scrolling `shift` pixels sideways per
    frame.  -> their paths."""
    import cv2

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = str(root / f"{prefix}{i}.mp4")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (640, 360))
        base = rng.integers(0, 256, (360, 640, 3), np.uint8)
        for t in range(seconds * fps):
            out.write(np.roll(base, shift * t, axis=1))
        out.release()
        paths.append(path)
    return paths


def _http(port, method, path, payload=None, timeout=600):
    """One request to the phase's server -> (status, parsed body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if payload is None
                 else json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _http_stream(port, payload, t_sent, timeout=600):
    """A streaming chat request -> (status, concatenated deltas, seconds to
    the first content delta, finish reason, [DONE] seen)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions",
                 body=json.dumps({**payload, "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    text, first, finish, done = "", None, None, False
    while resp.status == 200:
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode().strip()
        if line == "data: [DONE]":
            done = True
            break
        if not line.startswith("data: "):
            continue
        choice = json.loads(line[len("data: "):])["choices"][0]
        delta = choice["delta"].get("content", "")
        if delta and first is None:
            first = time.perf_counter() - t_sent
        text += delta
        finish = choice["finish_reason"] or finish
    conn.close()
    return resp.status, text, first, finish, done


def _token_agreement(texts_a, texts_b) -> list:
    """Per pair of answers, the share of positions whose words agree."""
    return [sum(a == b for a, b in zip(x.split(), y.split()))
            / max(len(x.split()), len(y.split()), 1)
            for x, y in zip(texts_a, texts_b)]


def http_phase(cfg, params, proc) -> dict:
    """Phase 4c: the OpenAI-compatible server (serving/server.py) on
    127.0.0.1, port 0, HTTP_SLOTS slots, prompt bucket HTTP_PROMPT_LEN,
    greedy, up to SERVE_GEN_KW's 64 new tokens: HTTP_VIDEOS video requests
    (mp4 files of 16 sampled frames of 360x640) and as many text requests,
    all sent at once from their own threads, so slots refill; one video
    request streams (SSE) and one text request uses /v1/completions.
    Gates: every status 200, the streamed deltas concatenate to that
    request's final text, every kernel of the path launched, a clean
    shutdown (the serving thread ends, the port refuses).  Reports each
    request's TTFT (submit to the end of its admission, on the server; and
    to the first SSE delta, on the client), its wall through HTTP, and the
    token agreement with generate_many on the same conversations (not
    gated).  Returns the path's launches."""
    import tempfile
    import threading

    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.serving import OpenAIServer

    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="smoke_http_", dir=root))
    try:
        videos = write_videos(tmp, "http", HTTP_VIDEOS, HTTP_VIDEO_SECONDS,
                              HTTP_VIDEO_FPS, seed=5, shift=5)
        rng = np.random.default_rng(6)
        words = [f"word{i}" for i in range(5000)]
        questions = ("how many chairs are in the room",
                     "what is left of the table", "where is the door")
        convs = [[{"role": "user", "content": [
            {"type": "video", "video": path},
            {"type": "text", "text": q}]}] for path, q in zip(videos, questions)]
        convs += [[{"role": "user", "content": " ".join(rng.choice(words, n))}]
                  for n in (200, 150, 120)]
        # one video request streams, the last text one is a plain completion
        stream_i, plain_i = 0, len(convs) - 1
        max_new = SERVE_GEN_KW["max_new_tokens"]
        server = OpenAIServer(cfg, params, proc, slots=HTTP_SLOTS,
                              prompt_len=HTTP_PROMPT_LEN,
                              max_new_tokens=max_new, temperature=0.0)
        submitted, admitted, streamed = {}, {}, []
        submit, admit = server.loop.submit, server.batcher.admit

        def timed_submit(request, *a, **kw):
            t = time.perf_counter()
            pending = submit(request, *a, **kw)
            submitted[id(pending)] = t
            if kw.get("stream"):
                streamed.append(pending)
            return pending

        def timed_admit(admissions):
            admit(admissions)
            torch.cuda.synchronize()
            now = time.perf_counter()
            for pending, *_ in admissions:
                admitted[id(pending)] = now

        server.loop.submit, server.batcher.admit = timed_submit, timed_admit
        results = [None] * len(convs)

        def client(i):
            t0 = time.perf_counter()
            conv = convs[i]
            if i == stream_i:
                status, text, first, finish, done = _http_stream(
                    port, {"messages": conv, "max_tokens": max_new}, t0)
                results[i] = dict(status=status, text=text, sse_ttft=first,
                                  finish=finish, done=done)
            elif i == plain_i:
                status, body = _http(port, "POST", "/v1/completions", {
                    "prompt": conv[0]["content"], "max_tokens": max_new})
                results[i] = dict(status=status, body=body, text=(
                    body.get("choices") or [{}])[0].get("text"))
            else:
                status, body = _http(port, "POST", "/v1/chat/completions", {
                    "messages": conv, "max_tokens": max_new})
                results[i] = dict(status=status, body=body, text=(
                    body.get("choices") or [{}])[0].get("message", {}).get(
                        "content"))
            results[i]["wall"] = time.perf_counter() - t0

        gc.collect()
        torch.cuda.empty_cache()
        port = server.start()
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(convs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        died = server.loop.died
        final = None
        if streamed and streamed[0].output is not None:
            out = streamed[0].output
            final = server._decode_text(out.sequences[:out.length])
        order = sorted(submitted, key=submitted.get)
        ttft = [admitted.get(k, float("nan")) - submitted[k] for k in order]
        server.stop()
        alive = server.loop._thread.is_alive()
        try:
            _http(port, "GET", "/health", timeout=10)
            refused = False
        except OSError:
            refused = True
        statuses = [r and r["status"] for r in results]
        log(f"http: {len(convs)} concurrent requests ({HTTP_VIDEOS} video, "
            f"{len(convs) - HTTP_VIDEOS} text) through {HTTP_SLOTS} slots, "
            f"wall {wall:.2f} s | statuses {statuses} | server-side TTFT s "
            f"(submit -> admitted), in submission order "
            f"{[round(x, 3) for x in ttft]} | wall s per request "
            f"{[round(r['wall'], 3) for r in results if r]} | SSE first delta "
            f"{results[stream_i] and results[stream_i]['sse_ttft']} s")
        log(f"http: launches {counts} | loop died: {died} | after stop: "
            f"serving thread alive {alive}, port refuses {refused}")
        if statuses != [200] * len(convs) or died:
            raise RuntimeError(f"http: statuses {statuses}, loop died {died}:"
                               f" {[r.get('body') for r in results if r]}")
        sse = results[stream_i]
        if not (sse["done"] and sse["finish"] in ("stop", "length")
                and final is not None and sse["text"] == final):
            raise RuntimeError(f"http: the streamed deltas {sse['text']!r} "
                               f"(done {sse['done']}, finish {sse['finish']})"
                               f" are not the request's final text {final!r}")
        if alive or not refused:
            raise RuntimeError("http: the server did not shut down cleanly")
        if min(counts[k] for k in HTTP_KERNELS) < 1:
            raise RuntimeError(f"http: a kernel of the path was never "
                               f"launched: {counts}")
        del server
        gc.collect()
        torch.cuda.empty_cache()
        # the same conversations through generate_many (its own prompt
        # buckets: the text prompts pad to 512, not HTTP_PROMPT_LEN)
        texts = QwenEngine(cfg, params, proc).generate_many(
            convs, **SERVE_GEN_KW)
        agree = _token_agreement([r["text"] for r in results], texts)
        log(f"http vs generate_many: {sum(x == 1 for x in agree)} of "
            f"{len(agree)} answers identical, token agreement per request "
            f"{[round(x, 4) for x in agree]} (not gated)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def serve_forced_drafts(cfg, params, requests, decode_quant, *,
                        prompt_len=HTTP_PROMPT_LEN, k=SPEC_K,
                        steps=SPEC_CHECK_STEPS, tol=BF16_TOL) -> dict:
    """The speculative block step (serving/speculative.py spec_decode_step)
    held against the sequential clock-ring step (K5) with forced drafts:
    the requests are admitted into two batchers of len(requests) slots (no
    EOS, so no row stops); the sequential one runs kb * steps ring steps
    (kb = 1 + k), recording every step's logits; the speculative one then
    takes `steps` block steps whose drafts are the sequential path's own
    greedy tokens, advancing along that path.  Each block position's logits
    are held against the sequential step's that predicts the same token
    (forced_draft_stats, gated by log_forced_drafts), and at the first step
    a kb = 1 block tells the attention's share of the difference from the
    GEMM row count's (control_stats).  -> stats, the block's and the ring's
    ms per step included."""
    import spacer_tpu_torch.serving.batcher as bm
    from spacer_tpu_torch.serving import ContinuousBatcher
    from spacer_tpu_torch.serving.speculative import spec_decode_step

    kb = 1 + k
    R = len(requests)
    kw = dict(slots=R, prompt_len=prompt_len, max_new_tokens=kb * steps + 1,
              eos_token_id=-1, temperature=0.0, decode_quant=decode_quant,
              chunk_steps=kb * steps)
    wave = [(i, req, kw["max_new_tokens"], i) for i, req in enumerate(requests)]
    seq = ContinuousBatcher(cfg, params, **kw)
    logits, ring_ms = [], []
    sample, step = bm.sample_logits, bm.ragged_decode_step

    def recorded(lg, *a, **kw2):
        logits.append(lg.float())
        return sample(lg, *a, **kw2)

    def timed(*a, **kw2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **kw2)
        torch.cuda.synchronize()
        ring_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    bm.sample_logits, bm.ragged_decode_step = recorded, timed
    try:
        seq.admit(wave)
        seq.decode_chunk()
    finally:
        bm.sample_logits, bm.ragged_decode_step = sample, step
    tokens = seq.out.clone()
    del seq
    if len(logits) != 1 + kb * steps:
        raise RuntimeError(f"forced drafts: the sequential run sampled "
                           f"{len(logits)} times, expected {1 + kb * steps}")
    spec = ContinuousBatcher(cfg, params, speculate_k=k, **kw)
    spec.admit(wave)
    if not torch.equal(spec.cur, tokens[:, 0]):
        raise RuntimeError("forced drafts: the admissions sampled other "
                           "first tokens")
    model = spec.decode_model
    ar = torch.arange(kb, device=tokens.device)
    st = dict(err=0.0, outside=0, elements=0, cos_min=1.0, clear=0, missed=0,
              agree=0, positions=0, block_ms=[])
    for s in range(steps):
        t = spec.t
        first = int(t[0])
        drafts = tokens[:, first:first + k]
        toks = torch.cat([spec.cur[:, None], drafts], dim=1)
        pos = (prompt_len + spec.delta + t - 1)[:, None] + ar

        def block(n):
            with torch.no_grad():
                return spec_decode_step(
                    model["layers"], model, cfg.text, toks[:, :n],
                    pos[None, :, :n].expand(3, R, n), spec.caches, spec.pmask,
                    t, ~spec.done).float()

        control = block(1) if s == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = block(kb)
        torch.cuda.synchronize()
        st["block_ms"].append((time.perf_counter() - t0) * 1e3)
        # block position i predicts token t + i, as the ring step whose
        # logits are logits[t + i]
        ref = torch.stack(logits[first:first + kb], dim=1)
        st.update(forced_draft_stats(st, lg, ref, drafts, tol))
        if control is not None:
            st.update(control_stats(control[:, 0], lg[:, 0], ref[:, 0], tol))
        # advance along the sequential path (every draft taken)
        spec.cur = tokens[:, first + k]
        spec.t = t + kb
    del spec
    st["ring_ms"] = statistics.median(ring_ms)
    st["block_ms"] = statistics.median(st["block_ms"])
    return st


def forced_draft_stats(st: dict, lg, ref, drafts, tol) -> dict:
    """One forced-draft block against the sequential logits `ref` of the
    same positions: st's running max error, elements outside
    tol * (1 + |ref|) of all compared, min cosine per position, drafts
    accepted, and the drafts whose sequential top-2 margin exceeds tol
    (`clear`) that were rejected (`missed`)."""
    k = drafts.shape[1]
    diff = (lg - ref).abs()
    top = ref[:, :k].topk(2, dim=-1).values
    clear = (top[..., 0] - top[..., 1]) > tol * (1 + top[..., 0].abs())
    hit = lg[:, :k].argmax(-1) == drafts
    return dict(
        err=max(st["err"], float(diff.max())),
        outside=st["outside"] + int((diff > tol * (1 + ref.abs())).sum()),
        elements=st["elements"] + diff.numel(),
        cos_min=min(st["cos_min"], float(
            torch.nn.functional.cosine_similarity(lg, ref, dim=-1).min())),
        clear=st["clear"] + int(clear.sum()),
        missed=st["missed"] + int((clear & ~hit).sum()),
        agree=st["agree"] + int(hit.sum()),
        positions=st["positions"] + hit.numel())


def control_stats(one, block0, seq0, tol) -> dict:
    """Where a forced-draft block's differences come from, at its first
    position: the block step run with kb = 1 (the sequential step's GEMM
    rows, the block's attention) against the sequential step ("attn"), and
    the kb-token block against that kb = 1 step (the same attention code,
    GEMMs at R * kb rows; "rows").  Max abs error and elements outside
    tol * (1 + |x|) of each."""
    out = {}
    for name, a, b in (("attn", one, seq0), ("rows", block0, one)):
        diff = (a - b).abs()
        out[f"{name}_err"] = float(diff.max())
        out[f"{name}_outside"] = int((diff > tol * (1 + b.abs())).sum())
    return out


def log_forced_drafts(tag, st, rows):
    """Logs a forced-draft check's stats and applies its gate (see
    SPEC_COS_TOL)."""
    log(f"{tag} forced drafts: {SPEC_CHECK_STEPS} block steps x {rows} rows "
        f"x kb {1 + SPEC_K}: logits max_abs_err {st['err']:.3e}, "
        f"{st['outside']} of {st['elements']} elements outside "
        f"{BF16_TOL:.0e} * (1 + |x|) (not gated), cosine min "
        f"{st['cos_min']:.5f} (tol {SPEC_COS_TOL}) | drafts accepted {st['agree']} of "
        f"{st['positions']}, {st['missed']} rejected of the {st['clear']} "
        f"with a top-2 margin over the tolerance | block step "
        f"{st['block_ms']:.2f} ms (M = {rows * (1 + SPEC_K)} rows) vs "
        f"sequential step {st['ring_ms']:.2f} ms | first position, kb = 1 "
        f"block vs sequential (attention alone): max_abs_err "
        f"{st['attn_err']:.3e}, {st['attn_outside']} outside; kb = "
        f"{1 + SPEC_K} vs kb = 1 (GEMM rows alone): {st['rows_err']:.3e}, "
        f"{st['rows_outside']} outside")
    if st["missed"] or not st["cos_min"] >= SPEC_COS_TOL:
        raise RuntimeError(f"{tag}: the block step disagrees with the "
                           "sequential step")


def spec_serve_phase(cfg, params, proc, msgs) -> dict:
    """Phase 4d: speculative serving (speculate_k = SPEC_K) at the serving
    slice's geometry, bf16 and int4_kv.  First the forced-draft check
    (serve_forced_drafts) over SPEC_CHECK_STEPS block steps at the 4 slots
    of msgs' requests in one prompt bucket; then generate_many on msgs with
    and without speculation: acceptance (spec_stats tokens per row-step),
    ms per block step against ms per ring step, tok/s, and the token
    agreement of the two (not gated).  Returns the launches of each
    speculative generate_many."""
    import spacer_tpu_torch.serving.speculative as spec_mod
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    paths = {}
    requests = [QwenEngine(cfg, params, proc).encode_request(m) for m in msgs]
    for quant, kernels in ((None, SPEC_SERVE_KERNELS),
                           ("int4_kv", SPEC_SERVE_INT4_KV_KERNELS)):
        tag = f"spec[{quant or 'bf16'}]"
        gc.collect()
        torch.cuda.empty_cache()
        log_forced_drafts(tag, serve_forced_drafts(cfg, params, requests,
                                                   quant), len(requests))
        runs = {}
        for k in (0, SPEC_K):
            engine = QwenEngine(cfg, params, proc, decode_quant=quant,
                                speculate_k=k)
            block_ms, block_bad, step = [], [], spec_mod.spec_decode_step

            def timed(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                block_ms.append((time.perf_counter() - t0) * 1e3)
                if not bool(torch.isfinite(out).all()):
                    block_bad.append(len(block_ms))
                return out

            gc.collect()
            torch.cuda.empty_cache()
            spec_mod.spec_decode_step = timed
            reset_launch_counts()
            try:
                with SliceProbe() as probe:
                    t0 = time.perf_counter()
                    texts = engine.generate_many(msgs, **SERVE_GEN_KW)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                spec_mod.spec_decode_step = step
            stats = [b.spec_stats for b in engine._batchers.values()]
            runs[k] = dict(texts=texts, wall=wall, tokens=sum(probe.lengths),
                           ring_ms=probe.decode_ms, block_ms=block_ms,
                           steps=sum(s["steps"] for s in stats),
                           emitted=sum(s["tokens"] for s in stats),
                           nonfinite=probe.nonfinite + len(block_bad),
                           counts=launch_counts(),
                           lengths=probe.lengths)
            del engine
        base, sp = runs[0], runs[SPEC_K]
        agree = _token_agreement(base["texts"], sp["texts"])
        log(f"{tag} generate_many: speculative {sp['tokens']} tokens in "
            f"{sp['wall']:.2f} s ({sp['tokens'] / sp['wall']:.1f} tok/s), "
            f"acceptance {sp['emitted']} tokens / {sp['steps']} row-steps = "
            f"{sp['emitted'] / max(sp['steps'], 1):.3f}, block step median "
            f"{statistics.median(sp['block_ms']):.2f} ms over "
            f"{len(sp['block_ms'])} | sequential {base['tokens']} tokens in "
            f"{base['wall']:.2f} s ({base['tokens'] / base['wall']:.1f} "
            f"tok/s), ring step median {statistics.median(base['ring_ms']):.2f}"
            f" ms | token agreement per request "
            f"{[round(x, 4) for x in agree]} (not gated) | launches "
            f"{sp['counts']}")
        if (len(sp["lengths"]) != len(msgs) or min(sp["lengths"]) < 1
                or sp["nonfinite"] or not sp["block_ms"] or sp["ring_ms"]):
            raise RuntimeError(f"{tag}: lengths {sp['lengths']}, "
                               f"{sp['nonfinite']} non-finite, "
                               f"{len(sp['block_ms'])} block and "
                               f"{len(sp['ring_ms'])} ring steps")
        if min(sp["counts"][k] for k in kernels) < 1:
            raise RuntimeError(f"{tag}: a kernel of the path was never "
                               f"launched: {sp['counts']}")
        paths[f"serve spec {quant or 'bf16'}"] = sp["counts"]
    return paths


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
        if kind == "mlp" and parts[4] in ("experts", "shared", "router"):
            return f"lm mlp {parts[4]}"
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


def group_cosines(names, ga, gb) -> dict:
    """Per tensor group (_grad_group), cosine(ga, gb) over the tensors that
    have a gradient in both sets."""
    sums = {}
    for n, a, b in zip(names, ga, gb):
        if a is None or b is None:
            continue
        a, b = a.float(), b.float()
        s = sums.setdefault(_grad_group(n), [0.0, 0.0, 0.0])
        s[0] += float((a * b).sum())
        s[1] += float(a.square().sum())
        s[2] += float(b.square().sum())
    return {g: d / math.sqrt(x * y) for g, (d, x, y) in sums.items()}


def replay_grads(run, names, tag="train", select=None):
    """An update's loss and backward, once with the kernels and once with
    plain attention, on the same params and batch: `run(select)` returns
    loss_and_grads' (loss, metrics, grads).  Every tensor that gets a
    gradient (all, or those `select` accepts where two full gradient sets
    do not fit) must get a finite, nonzero one from the kernel run, the
    plain run must launch no kernel, and each tensor group's gradient
    cosine against the plain run must be >= GRAD_COS_TOL.  Returns the
    kernel launches this check made (they are comparisons, not the path's)
    and its seconds."""
    from spacer_tpu_torch.ops import launch_counts

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before = launch_counts()
    with RouteLog() as routes:
        loss_k, _, gk = run(select)
    after = launch_counts()
    extra = {k: n - before[k] for k, n in after.items()}
    checked = [(n, g) for n, g in zip(names, gk) if g is not None]
    bad = [n for n, g in checked
           if not (bool(torch.isfinite(g).all()) and bool(g.any()))]
    if bad:
        raise RuntimeError(f"{len(bad)} trainable tensors got a zero or "
                           f"non-finite gradient: {bad[:8]}")
    with plain_kernels(), RouteLog(replay=routes.idx) as ref_routes:
        loss_p, _, gp = run(select)
    routes = None
    if launch_counts() != after:
        raise RuntimeError("the plain-attention replay launched a kernel")
    cos = group_cosines(names, gk, gp)
    del gk, gp
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    which = ("all" if select is None
             else f"{len(checked)} selected of {len(names)}")
    log(f"{tag}: {which} trainable tensors with finite nonzero gradients | "
        f"step-1 loss kernel {float(loss_k):.6e} plain {float(loss_p):.6e} "
        f"| replay {seconds:.2f} s" + ref_routes.note())
    log(f"{tag}: gradient cosine kernel vs plain attention per group: "
        + ", ".join(f"{g} {c:.5f}" for g, c in sorted(cos.items())))
    if not min(cos.values()) >= GRAD_COS_TOL:
        raise RuntimeError(f"gradient cosine below {GRAD_COS_TOL}: {cos}")
    return extra, seconds


def grpo_run(step_fn, params, batch, kw):
    """replay_grads' `run` for a GRPO update batch (with its ref_logps)."""
    args = (params, batch["ref_logps"],
            {k: v for k, v in batch.items() if k != "ref_logps"},
            kw["grid_thw"], kw["num_generations"])
    return lambda select: step_fn.loss_and_grads(*args, select=select)


def replay_first_step(step_fn, names, params, batch, kw):
    """Phase 5's replay: every tensor's gradient (replay_grads)."""
    return replay_grads(grpo_run(step_fn, params, batch, kw), names)


def video_row(shape, seed: int, problem_id: int = 0) -> dict:
    """A training row over a random uint8 video of (frames, H, W)."""
    from spacer_tpu_torch.data import make_conversation

    frames = np.random.default_rng(seed).integers(0, 256, (*shape, 3),
                                                  np.uint8)
    row = {"problem": "How many chairs are in the room?",
           "problem_type": "numerical", "solution": "<answer>3</answer>",
           "path": frames, "data_type": "video", "data_source": "synthetic",
           "problem_id": problem_id}
    row.update(make_conversation(row))
    return row


def make_trainer(cfg, device, steps: int, out_dir: str,
                 videos=((16, 360, 640),), mesh=None, share_ref=False,
                 **overrides):
    """The training slice's SGRLVRTrainer at the widths of `cfg`: random
    bf16 weights from seed 0, one row per shape in `videos` (by default one
    16-frame 360x640 video), temporal shuffle merged into the rollout
    (2 prompts per row x TRAIN_G completions of up to TRAIN_NEW_TOKENS
    tokens), the trainer's default int8_kv rollouts, beta 0.04, int8
    moments, `steps` steps; `overrides` replace SGRLVRConfig fields.  With
    a `mesh` the params are sharded onto it (QWEN_PARTITION_RULES, and
    split over its tp axis by the Qwen tp plan);
    `share_ref` makes the reference model the policy's own tensors (the
    same values until the first update, without a second copy).
    Returns (trainer, the params' paths in param_leaves order)."""
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
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
    rows = [video_row(shape, 1 + i, i) for i, shape in enumerate(videos)]
    shutil.rmtree(out_dir, ignore_errors=True)
    args = SGRLVRConfig(
        num_generations=TRAIN_G, max_completion_length=TRAIN_NEW_TOKENS,
        temperature=1.0, top_p=0.95, beta=0.04, temporal=True,
        moment_dtype="int8", max_steps=steps,
        num_train_epochs=steps, logging_steps=1, save_steps=10 ** 9,
        skip_failed_steps=False, output_dir=out_dir, seed=0)
    args = dataclasses.replace(args, **overrides)
    if mesh is not None:
        from spacer_tpu_torch.parallel.partition import (
            QWEN_PARTITION_RULES,
            qwen_tp_plan,
            shard_params,
        )

        params = shard_params(params, mesh, QWEN_PARTITION_RULES,
                              qwen_tp_plan(cfg))[0]
        gc.collect()
        torch.cuda.empty_cache()
    trainer = SGRLVRTrainer(
        cfg, params, proc, [synthetic_reward, accuracy_reward, format_reward],
        rows, args, mesh=mesh, ref_params=params if share_ref else None)
    return trainer, names


def train_slice(cfg, device="cuda", phases=PHASES) -> dict:
    """Phases 5 and 5b: two SG-RLVR optimizer steps through
    SGRLVRTrainer.train at the widths of `cfg` (make_trainer): merged
    int8_kv rollout (K1 prefill + K2-int8 decode, held against its plain
    version on live inputs), rewards, group advantages, reference logps, the
    shared-prefix policy forward/backward (K1, K1-bwd, K3, K4) and the
    int8-moment AdamW update.  The first update is replayed with plain
    attention (replay_first_step); the replay's time is reported apart from
    the steps'.  Then one bf16 rollout of the first step's batch
    (rollout_bf16) and, if selected, phase 5c on that batch
    (spec_rollout_phase).  Returns {path: {kernel id: count}}."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    out_dir = str(pathlib.Path(__file__).resolve().parent / "build" / "smoke_train")
    trainer, names = make_trainer(cfg, device, 2, out_dir)
    step_fn, steps, extra, replay_s = trainer.step_fn, [], {}, []
    first = {}

    def spy(params, ref_params, opt_state, batch, **kw):
        if not steps:
            first.update(batch=batch, kw=kw)
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
    # the reference copy and the moments are done with: room for the remat
    # modes' two gradient sets
    trainer.ref_params = trainer.opt_state = None
    remat_counts = remat_modes(trainer, names, first["batch"], first["kw"])
    first.clear()
    a, kw = rollouts[0]
    paths = {"train int8_kv": counts, "train remat modes": remat_counts,
             "rollout bf16": rollout_bf16(trainer, a, kw)}
    if "5c" in phases:
        paths.update(spec_rollout_phase(trainer, a, kw))
    return paths


def remat_modes(trainer, names, batch, kw) -> dict:
    """Phase 5's addition: phase 5's first update batch, loss and backward
    on the trained params under each of REMAT_MODES (remat=True first),
    twice each: the loss within REMAT_LOSS_RTOL of True's and a per-group
    gradient cosine >= REMAT_COS_TOL against True's; the seconds of each
    run and the peak memory above what was allocated before it (this
    mode's activations and gradients; True's gradients, kept for the
    cosine, are not counted).  Attention is recomputed under every mode,
    so each run launches K1 four times per LM layer (prompt and completion
    passes, each again in the backward) and the K1-bwd kernels twice.
    Returns the launches."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.train.step import make_grpo_train_step

    args, L = trainer.args, trainer.cfg.text.num_layers
    total, ref, rows = collections.Counter(), None, []
    for mode in REMAT_MODES:
        step = make_grpo_train_step(trainer.cfg, trainer.tx, beta=args.beta,
                                    remat=mode, logp_chunk=args.logp_chunk)
        run = grpo_run(step, trainer.params, batch, kw)
        secs = []
        for _ in range(2):
            grads = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, _, grads = run(None)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = launch_counts()
            total.update(counts)
        peak = (torch.cuda.max_memory_allocated() - base,
                torch.cuda.max_memory_reserved())
        if counts["K1"] != 4 * L or counts["K1-bwd dq"] != 2 * L:
            raise RuntimeError(f"remat={mode!r}: K1 {counts['K1']} / dq "
                               f"{counts['K1-bwd dq']} launches, expected "
                               f"{4 * L} / {2 * L} (attention recomputed)")
        if ref is None:
            ref, note = (float(loss), grads), "reference"
        else:
            rel = abs(float(loss) - ref[0]) / abs(ref[0])
            cos = group_cosines(names, ref[1], grads)
            note = (f"loss rel diff {rel:.2e} | min group cosine "
                    f"{min(cos.values()):.6f}")
            if not (rel <= REMAT_LOSS_RTOL and
                    min(cos.values()) >= REMAT_COS_TOL):
                raise RuntimeError(f"remat={mode!r} changed the update: "
                                   f"{note}: {cos}")
        del grads
        rows.append(f"remat={mode!r}: forward+backward "
                    f"{' / '.join(f'{t:.3f}' for t in secs)} s, peak "
                    f"{peak[0] / 2**30:.2f} GiB above the start "
                    f"(max_memory_reserved {peak[1] / 2**30:.2f} GiB), loss "
                    f"{float(loss):.6e}, K1 {counts['K1']} launches | {note}")
    ref = None
    for row in rows:
        log(f"train remat modes ({L} layers, phase 5's first batch): {row}")
    return dict(total)


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


def rollout_forced_drafts(trainer, args, kwargs, decode_quant, *, k=SPEC_K,
                          steps=SPEC_CHECK_STEPS, tol=BF16_TOL) -> dict:
    """The speculative grouped block step (sampler/speculating.py
    _spec_grouped_step) held against the sequential grouped step (K2 /
    K2-int8) with forced drafts, on the rollout batch `args` / `kwargs`:
    Sampler.generate decodes greedily kb * steps + 1 tokens (kb = 1 + k),
    recording every sampled step's logits and the decode loop's prefix
    caches; block steps over fresh tails then take the sequential tokens as
    drafts and advance along that path.  The tolerances are
    serve_forced_drafts'.  -> stats, with the block's and the sequential
    step's ms."""
    import spacer_tpu_torch.sampler.sampler as sm
    from spacer_tpu_torch.sampler import Sampler
    from spacer_tpu_torch.sampler.speculating import _spec_grouped_step

    kb = 1 + k
    sampler = Sampler(trainer.cfg, eos_token_id=trainer.sampler.eos_token_id,
                      pad_token_id=trainer.sampler.pad_token_id,
                      length_bucket=trainer.sampler.length_bucket,
                      decode_quant=decode_quant)
    args = (*args[:2], trainer.params, *args[3:])
    kwargs = dict(kwargs, max_new_tokens=kb * steps + 1, temperature=0.0,
                  top_p=1.0)
    captured, logits, seq_ms = {}, [], []
    loop, sample, step = sm._decode_loop, sm.sample_logits, \
        sm.lm_decode_step_split

    def capture(model, text_cfg, prefix, tails, prefix_mask, first, deltas,
                prompt_len, group, *rest):
        captured.update(model=model, prefix=prefix, prefix_mask=prefix_mask,
                        first=first.clone(), deltas=deltas, S=prompt_len,
                        G=group, tails=[tuple(torch.zeros_like(x) for x in e)
                                        for e in tails])
        return loop(model, text_cfg, prefix, tails, prefix_mask, first,
                    deltas, prompt_len, group, *rest)

    def recorded(lg, *a, **kw):
        logits.append(lg.float())
        return sample(lg, *a, **kw)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize()
        seq_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    sm._decode_loop, sm.sample_logits, sm.lm_decode_step_split = \
        capture, recorded, timed
    try:
        out = sampler.generate(*args, **kwargs)
    finally:
        sm._decode_loop, sm.sample_logits, sm.lm_decode_step_split = \
            loop, sample, step
    if len(logits) != 1 + kb * steps:
        raise RuntimeError(f"rollout forced drafts: {len(logits)} sampled "
                           f"steps, expected {1 + kb * steps}")
    c = captured
    model, dev = c["model"], c["first"].device
    tokens = torch.as_tensor(out.sequences, device=dev)
    N = tokens.shape[0]
    t = torch.ones((N,), dtype=torch.long, device=dev)
    cur = c["first"].long()
    ar = torch.arange(kb, device=dev)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    st = dict(err=0.0, outside=0, elements=0, cos_min=1.0, clear=0, missed=0,
              agree=0, positions=0, block_ms=[])
    for s in range(steps):
        first = int(t[0])
        drafts = tokens[:, first:first + k]
        toks = torch.cat([cur[:, None], drafts], dim=1)
        pos = (c["S"] + c["deltas"] + t - 1)[:, None] + ar

        def block(n):
            with torch.no_grad():
                return _spec_grouped_step(
                    model["layers"], model, trainer.cfg.text, toks[:, :n],
                    pos[None, :, :n].expand(3, N, n), c["prefix"],
                    c["prefix_mask"], c["tails"], t, active, c["G"]).float()

        control = block(1) if s == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = block(kb)
        torch.cuda.synchronize()
        st["block_ms"].append((time.perf_counter() - t0) * 1e3)
        ref = torch.stack(logits[first:first + kb], dim=1)
        st.update(forced_draft_stats(st, lg, ref, drafts, tol))
        if control is not None:
            st.update(control_stats(control[:, 0], lg[:, 0], ref[:, 0], tol))
        cur, t = tokens[:, first + k], t + kb
    st["ring_ms"] = statistics.median(seq_ms)
    st["block_ms"] = statistics.median(st["block_ms"])
    return st


def spec_rollout_phase(trainer, args, kwargs) -> dict:
    """Phase 5c: speculative rollouts (speculate_k = SPEC_K) of phase 5's
    first rollout batch on the trained params, at int8_kv (the trainer's
    default) and bf16: the forced-draft check (rollout_forced_drafts) over
    SPEC_CHECK_STEPS block steps, then Sampler.generate with and without
    speculation at the trainer's sampling settings: acceptance and seconds
    of each.  Returns the launches of each speculative rollout."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.sampler import Sampler

    paths = {}
    gen_args = (*args[:2], trainer.params, *args[3:])
    for quant in ("int8_kv", None):
        tag = f"rollout spec[{quant or 'bf16'}]"
        gc.collect()
        torch.cuda.empty_cache()
        st = rollout_forced_drafts(trainer, args, kwargs, quant)
        log_forced_drafts(tag, st, args[0].shape[0] * kwargs["num_generations"])
        sampler = Sampler(trainer.cfg,
                          eos_token_id=trainer.sampler.eos_token_id,
                          pad_token_id=trainer.sampler.pad_token_id,
                          length_bucket=trainer.sampler.length_bucket,
                          decode_quant=quant)
        runs = {}
        for k in (0, SPEC_K):
            gc.collect()
            torch.cuda.empty_cache()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = sampler.generate(*gen_args, speculate_k=k, **kwargs)
            torch.cuda.synchronize()
            runs[k] = dict(wall=time.perf_counter() - t0, out=out,
                           counts=launch_counts())
        base, sp = runs[0], runs[SPEC_K]
        stats = sp["out"].stats
        log(f"{tag}: {sp['out'].sequences.shape[0]} completions, "
            f"{int(sp['out'].lengths.sum())} tokens in {sp['wall']:.2f} s vs "
            f"sequential {int(base['out'].lengths.sum())} tokens in "
            f"{base['wall']:.2f} s (temperature "
            f"{kwargs.get('temperature')}, top_p {kwargs.get('top_p')}) | "
            f"acceptance {stats['spec_tokens']} tokens / "
            f"{stats['spec_row_steps']} row-steps = "
            f"{stats['spec_acceptance']:.3f} | launches {sp['counts']}")
        if (min(sp["out"].lengths) < 1
                or min(sp["counts"][k] for k in SPEC_ROLLOUT_KERNELS) < 1):
            raise RuntimeError(f"{tag}: lengths {sp['out'].lengths}, "
                               f"launches {sp['counts']}")
        paths[tag] = sp["counts"]
    return paths


def full_replay_select(cfg):
    """The tensors whose gradients the full-depth replays compare: every
    tensor of the first and last LM layers, of ViT blocks 0 (windowed, K3),
    7 (full attention, K4) and the last, and the merger.  Two gradient sets
    of all 8.29 B params (2 x 16.6 GB) do not fit beside the params and the
    reference copy; these ~0.5 B params' do, and their backward runs
    through every layer's attention (K1-bwd) and the whole ViT."""
    lm = {"0", str(cfg.text.num_layers - 1)}
    vit = {"0", str(cfg.vision.fullatt_block_indexes[0]),
           str(cfg.vision.depth - 1)}

    def select(name: str) -> bool:
        p = name.split("/")
        if p[:2] == ["model", "layers"]:
            return p[2] in lm
        if p[:2] == ["visual", "blocks"]:
            return p[2] in vit
        return p[:2] == ["visual", "merger"]

    return select


class ApplyProbe:
    """Wraps an optimizer's `apply`: every gradient it is handed must be
    finite and nonzero (exactly zero where `zero(path)` says the math makes
    it so); times the apply (synchronised) and records the memory peak
    before it (the forward and backward) and during it."""

    def __init__(self, tx, names, tag, zero=lambda name: False):
        self.tx, self.names, self.tag = tx, names, tag
        self.calls = []
        apply = tx.apply

        def checked(grads, state, params, **kw):
            bad = [n for n, g in zip(self.names, grads)
                   if not (bool(torch.isfinite(g).all())
                           and bool(g.any()) != zero(n))]
            if bad:
                raise RuntimeError(f"{tag}: {len(bad)} trainable tensors got "
                                   f"a non-finite gradient, or a zero one "
                                   f"where it must not be (or the reverse): "
                                   f"{bad[:8]}")
            torch.cuda.synchronize()
            before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = apply(grads, state, params, **kw)
            torch.cuda.synchronize()
            self.calls.append(dict(
                seconds=time.perf_counter() - t0, fwd_bwd_peak=before,
                peak=torch.cuda.max_memory_allocated(),
                reserved=torch.cuda.max_memory_reserved()))
            return out

        tx.apply = checked


def gib(n) -> str:
    return f"{n / 2**30:.2f} GiB"


def full_train_slice(cfg, device="cuda"):
    """Phase 8: SG-RLVR at full Qwen2.5-VL-7B depth through
    SGRLVRTrainer.train: two rows (FULL_VIDEOS) in one rollout of 4
    prompts (mixed grids: K4 once per grid), G = TRAIN_G, int8_kv rollouts
    (K2-int8 held against its plain version live), int8 moments and the
    accumulator offloaded to host memory, remat=True,
    gradient_accumulation_steps=FULL_ACCUM_STEPS: two training_step calls
    make one optimizer step.  Checks: after call 1 the params equal the
    reference copy bitwise and the state is in host memory; after call 2
    the params moved, every gradient handed to the optimizer (both calls)
    was finite and nonzero, loss / kl / grad_norm are finite; the first
    update replayed with plain attention on full_replay_select's tensors
    has per-group cosine >= GRAD_COS_TOL.  Prints each call's rollout /
    reward / update seconds, the peaks of the rollout, the forward and
    backward, and the optimizer apply (the offload copies), and the
    apply's seconds and bytes streamed.  Returns (launches, the first
    update's batch and step arguments, the trainer)."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel import is_on_host
    from spacer_tpu_torch.parallel.offload import (
        host_bytes,
        mem_available_bytes,
    )
    import spacer_tpu_torch.models.qwen25_vl.vision as vis

    out_dir = str(pathlib.Path(__file__).resolve().parent / "build"
                  / "smoke_train_full")
    avail0 = mem_available_bytes()
    t0 = time.perf_counter()
    trainer, names = make_trainer(
        cfg, device, FULL_ACCUM_STEPS, out_dir, videos=FULL_VIDEOS,
        rollout_batch_size=len(FULL_VIDEOS),
        gradient_accumulation_steps=FULL_ACCUM_STEPS, offload_opt_state=True)
    state_bytes = host_bytes(trainer.opt_state)
    log(f"train full: optimizer state in host memory {state_bytes / 1e9:.2f} "
        f"GB (int8 moments + bf16 accumulator) | host MemAvailable "
        f"{avail0 / 1e9 if avail0 else float('nan'):.2f} -> "
        f"{(mem_available_bytes() or 0) / 1e9:.2f} GB | setup "
        f"{time.perf_counter() - t0:.1f} s | device "
        f"{gib(torch.cuda.memory_allocated())} allocated")
    if not is_on_host(trainer.opt_state):
        raise RuntimeError("offload_opt_state: the state is not on the host")
    step_fn, calls, extra, first = trainer.step_fn, [], {}, {}
    apply_probe = ApplyProbe(trainer.tx, names, "train full")
    select = full_replay_select(cfg)

    def spy(params, ref_params, opt_state, batch, **kw):
        if not calls:
            first.update(batch=batch, kw=kw)
            e, sec = replay_grads(grpo_run(step_fn, params, batch, kw),
                                  names, "train full", select)
            extra.update(e)
            first["replay_s"] = sec
        else:
            # after the first mini-step: nothing applied, state on the host
            same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                _named(params), _named(ref_params)))
            if not (same and opt_state.mini_step == 1
                    and is_on_host(opt_state)):
                raise RuntimeError(
                    f"after mini-step 1: params unchanged {same}, mini_step "
                    f"{opt_state.mini_step}, on host {is_on_host(opt_state)}")
            log("train full: after call 1 the params equal the reference "
                "copy bitwise, mini_step 1, moments and accumulator on the "
                "host")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = step_fn(params, ref_params, opt_state, batch, **kw)
        torch.cuda.synchronize()
        calls.append(dict({k: float(v) for k, v in out[2].items()},
                          update_s=time.perf_counter() - t,
                          pads=(batch["prompt_mask"] == 0).sum(1).tolist(),
                          prompt_len=batch["prompt_ids"].shape[1]))
        return out

    spy.ref_logps_fn = step_fn.ref_logps_fn
    trainer.step_fn = spy
    generate, rollouts, k4_chunks = trainer.sampler.generate, [], set()

    def recorded_generate(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = generate(*a, **kw)
        torch.cuda.synchronize()
        rollouts.append((kw["grid_thw"], torch.cuda.max_memory_allocated(),
                         torch.cuda.max_memory_reserved()))
        return out

    chunk_fn = vis.chunk_attention_hsd

    def recorded_chunk(q, k, v, wt, scale):
        k4_chunks.add((q.shape[1], wt))
        return chunk_fn(q, k, v, wt, scale)

    trainer.sampler.generate = recorded_generate
    vis.chunk_attention_hsd = recorded_chunk
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    try:
        with DecodeProbe() as probe:
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        vis.chunk_attention_hsd = chunk_fn
    counts = {k: n - extra.get(k, 0) for k, n in launch_counts().items()}
    with open(pathlib.Path(out_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    acc_bytes = sum(a.numel() * a.element_size()
                    for a in trainer.opt_state.acc_grads)
    moment_bytes = state_bytes - acc_bytes
    for i, (c, rec, ap, ro) in enumerate(zip(calls, records,
                                              apply_probe.calls, rollouts)):
        emit = (i + 1) % FULL_ACCUM_STEPS == 0
        streamed = (acc_bytes * (1 if i % FULL_ACCUM_STEPS else 0)
                    + (2 * moment_bytes if emit else acc_bytes))
        log(f"train full call {i + 1} ({'emit' if emit else 'accumulate'}): "
            f"loss {c['loss']:.6e} kl {c['kl']:.6e} grad_norm "
            f"{c['grad_norm']:.6e} | rollout {rec['time/rollout_s']:.2f} s, "
            f"reward {rec['time/reward_s']:.3f} s, update {c['update_s']:.2f} "
            f"s (optimizer apply {ap['seconds']:.3f} s, {streamed / 1e9:.2f} "
            f"GB streamed host<->device) | peaks: rollout {gib(ro[1])} "
            f"(reserved {gib(ro[2])}), forward+backward "
            f"{gib(ap['fwd_bwd_peak'])}, apply {gib(ap['peak'])} (reserved "
            f"{gib(ap['reserved'])}) | prompt bucket {c['prompt_len']} pads "
            f"{c['pads']}")
    log(f"train full: wall {wall:.1f} s incl. the first update's partial "
        f"replay {first.get('replay_s', 0):.1f} s | rollout decode ms per "
        f"step median {statistics.median(probe.decode_ms()):.2f} over "
        f"{len(probe.decode_ms())} unchecked steps of the "
        f"{cfg.text.num_layers}-layer LM | rollout grids {rollouts[0][0]} | "
        f"K4 (tokens, chunk) {sorted(k4_chunks)} | launches {counts}")
    log(f"train full: K2-int8 vs plain on live rollout inputs: "
        f"{len(probe.k2_err)} calls at (q shape, P, T) "
        f"{sorted(probe.k2_shapes)}, max_abs_err "
        f"{max(probe.k2_err, default=float('nan')):.3e}, {probe.k2_bad} outside")
    st = trainer.opt_state
    if trainer.global_step != FULL_ACCUM_STEPS or len(calls) != 2:
        raise RuntimeError(f"expected {FULL_ACCUM_STEPS} calls, got {len(calls)}")
    if (st.mini_step, st.gradient_step, st.inner_opt_state.count) != (0, 1, 1):
        raise RuntimeError(f"one optimizer step expected: {st.mini_step} "
                           f"{st.gradient_step} {st.inner_opt_state.count}")
    if not is_on_host(st):
        raise RuntimeError("the optimizer state left the host")
    for c in calls:
        if not all(math.isfinite(c[k]) for k in ("loss", "kl", "grad_norm")):
            raise RuntimeError(f"non-finite step metrics {c}")
        # the rows' order in the batch follows the epoch's permutation
        if (c["prompt_len"], sorted(c["pads"])) != (TRAIN_PROMPT_BUCKET,
                                                    sorted(FULL_PROMPT_PADS)):
            raise RuntimeError(f"prompt bucket {c['prompt_len']} pads "
                               f"{c['pads']}, expected {TRAIN_PROMPT_BUCKET} "
                               f"{FULL_PROMPT_PADS}")
    if not probe.k2_err or probe.k2_bad:
        raise RuntimeError(f"K2-int8 disagrees with its plain version on "
                           f"{probe.k2_bad} of {len(probe.k2_err)} live calls")
    if probe.nonfinite:
        raise RuntimeError(f"{probe.nonfinite} rollout steps sampled "
                           f"non-finite logits")
    chunks = {wt for _, wt in k4_chunks}
    want = {h * w for _, h, w in FULL_GRIDS}
    if not want <= chunks or sorted(rollouts[0][0]) != sorted(FULL_GRIDS * 2):
        raise RuntimeError(f"mixed grids: K4 chunks {chunks}, rollout grids "
                           f"{rollouts[0][0]}")
    moved = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(
        _named(trainer.params), _named(trainer.ref_params)))
    mu_moved = sum(bool(s.any()) for _, s in st.inner_opt_state.mu)
    log(f"train full: after the optimizer step {moved} of {len(names)} "
        f"tensors changed (bf16 params, lr {trainer.args.learning_rate:g}); "
        f"int8 moments moved in {mu_moved} of {len(st.inner_opt_state.mu)} "
        f"groups")
    if not moved or mu_moved != len(st.inner_opt_state.mu):
        raise RuntimeError("the optimizer step moved nothing")
    offload_copy_times(st, device)
    if min(counts[k] for k in FULL_TRAIN_KERNELS) < 1:
        raise RuntimeError(f"a kernel of the full-depth path was never "
                           f"launched: {counts}")
    return counts, first, trainer


def offload_copy_times(state, device):
    """The offload's copies alone: every host tensor of the optimizer state
    to the card and back, one at a time, each timed by CUDA events."""
    hosts = ([a for a in state.acc_grads]
             + [t for pair in (*state.inner_opt_state.mu,
                               *state.inner_opt_state.nu) for t in pair])
    h2d = d2h = 0.0
    for h in hosts:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        d = h.to(device, non_blocking=True)
        marks[1].record()
        h.copy_(d, non_blocking=True)
        marks[2].record()
        marks[2].synchronize()
        h2d += marks[0].elapsed_time(marks[1])
        d2h += marks[1].elapsed_time(marks[2])
        del d
    nbytes = sum(h.numel() * h.element_size() for h in hosts)
    log(f"train full: offload copies alone, {len(hosts)} tensors, "
        f"{nbytes / 1e9:.2f} GB each way: host-to-device {h2d / 1e3:.3f} s "
        f"({nbytes / h2d / 1e6:.1f} GB/s), device-to-host {d2h / 1e3:.3f} s "
        f"({nbytes / d2h / 1e6:.1f} GB/s); pinned "
        f"{all(h.is_pinned() for h in hosts)}")


def _named(params):
    from spacer_tpu_torch.train.step import param_leaves

    return param_leaves(params)


def lora_phase(trainer, first) -> dict:
    """Phase 8b: one make_lora_grpo_train_step step (r 8 on q/k/v/o of all
    28 layers, int8 moments) on phase 8's first update batch with the
    trained params as the frozen base: the base stays bitwise unchanged
    (held against a copy), the adapters' gradients are finite, every b's
    nonzero (every a's exactly zero: b starts at zero), and K1 / K1-bwd are
    launched.  Returns the launches."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.train.lora import (
        LoraConfig,
        init_lora_params,
        lora_leaves,
        make_lora_grpo_train_step,
    )
    from spacer_tpu_torch.train.optimizer import make_optimizer

    cfg, args = trainer.cfg, trainer.args
    params = trainer.params
    trainer.ref_params = trainer.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    snapshot = [t.detach().clone() for _, t in _named(params)]
    lcfg = LoraConfig()
    dev = snapshot[0].device
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(0),
                            params, lcfg)
    leaves = lora_leaves(lora)
    tx = make_optimizer(learning_rate=1e-4, total_steps=10,
                        moment_dtype="int8", seed=0)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    # b starts at zero, so the first step's gradient of every a is exactly
    # zero (x^T dy b^T) and every b's is not
    ApplyProbe(tx, [n for n, _ in leaves], "lora",
               zero=lambda n: n.endswith("/a"))
    step = make_lora_grpo_train_step(cfg, tx, lcfg, beta=args.beta,
                                     remat=args.remat,
                                     logp_chunk=args.logp_chunk)
    batch = {k: v for k, v in first["batch"].items() if k != "ref_logps"}
    b0 = [t.clone() for n, t in leaves if n.endswith("/b")]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lora, state, m = step(params, lora, state, batch, **first["kw"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    same = all(torch.equal(a, t) for a, (_, t) in zip(snapshot, _named(params)))
    b_moved = sum(not torch.equal(a, t) for a, (n, t) in zip(
        b0, [(n, t) for n, t in lora_leaves(lora) if n.endswith("/b")]))
    log(f"lora: {len(lora)} adapters (r {lcfg.r}, {sum(t.numel() for _, t in leaves) / 1e6:.1f} M params) "
        f"| loss {float(m['loss']):.6e} kl {float(m['kl']):.6e} grad_norm "
        f"{float(m['grad_norm']):.6e} | {sec:.2f} s | max_memory_allocated "
        f"{gib(torch.cuda.max_memory_allocated())} | base bitwise unchanged "
        f"{same} | b moved in {b_moved} of {len(b0)} | launches {counts}")
    del snapshot
    if not same:
        raise RuntimeError("the LoRA step changed the base params")
    if not all(math.isfinite(float(m[k])) for k in ("loss", "kl", "grad_norm")):
        raise RuntimeError(f"non-finite LoRA metrics {m}")
    if min(counts[k] for k in LORA_KERNELS) < 1:
        raise RuntimeError(f"a kernel of the LoRA step was never launched: "
                           f"{counts}")
    return counts


def sft_phase(cfg, device="cuda") -> dict:
    """Phase 9: two SFTTrainer steps at full Qwen2.5-VL-7B depth, int8
    moments on the card, remat=True, on one 16-frame 360x640 video row with
    a templated answer: finite losses, every gradient handed to the
    optimizer finite and nonzero, the first step replayed with plain
    attention on full_replay_select's tensors (per-group cosine >=
    GRAD_COS_TOL), the peaks printed.  Returns the launches."""
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.train.sft_trainer import SFTConfig, SFTTrainer

    out_dir = str(pathlib.Path(__file__).resolve().parent / "build"
                  / "smoke_sft")
    shutil.rmtree(out_dir, ignore_errors=True)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    names = [n for n, _ in _named(params)]
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg,
                       device=device)
    row = dict(video_row(FULL_VIDEOS[0], 1),
               solution="<think>Let me think. Two chairs by the table and one "
               "by the window.</think><answer>3</answer>")
    trainer = SFTTrainer(cfg, params, proc, [row], SFTConfig(
        moment_dtype="int8", max_steps=2, num_train_epochs=2, logging_steps=1,
        save_steps=10 ** 9, output_dir=out_dir, seed=0))
    apply_probe = ApplyProbe(trainer.tx, names, "sft")
    step_fn, steps, extra = trainer.step_fn, [], {}
    select = full_replay_select(cfg)

    def spy(params, opt_state, batch, grid_thw=None):
        if not steps:
            extra.update(replay_grads(
                lambda sel: step_fn.loss_and_grads(params, batch, grid_thw,
                                                   select=sel),
                names, "sft", select)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = step_fn(params, opt_state, batch, grid_thw=grid_thw)
        torch.cuda.synchronize()
        steps.append(dict(loss=float(out[2]["loss"]),
                          n_tokens=int(out[2]["n_tokens"]),
                          seconds=time.perf_counter() - t,
                          seq=batch["input_ids"].shape[1], grid=grid_thw))
        return out

    trainer.step_fn = spy
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    trainer.train()
    counts = {k: n - extra.get(k, 0) for k, n in launch_counts().items()}
    for i, (st, ap) in enumerate(zip(steps, apply_probe.calls)):
        log(f"sft step {i + 1}: loss {st['loss']:.6e} over {st['n_tokens']} "
            f"tokens, sequence {st['seq']}, grid {st['grid']} | "
            f"{st['seconds']:.2f} s (optimizer apply {ap['seconds']:.3f} s) | "
            f"peaks: forward+backward {gib(ap['fwd_bwd_peak'])}, apply "
            f"{gib(ap['peak'])} (reserved {gib(ap['reserved'])})")
    log(f"sft: launches {counts}")
    if len(steps) != 2 or not all(math.isfinite(s["loss"]) for s in steps):
        raise RuntimeError(f"SFT steps {steps}")
    if min(counts[k] for k in SFT_KERNELS) < 1:
        raise RuntimeError(f"a kernel of the SFT path was never launched: "
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
    write_videos(root, "v", 2, EVAL_VIDEO_SECONDS, EVAL_VIDEO_FPS, seed=3,
                 shift=7)
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


class ChunkProbe:
    """Holds the ViT's K4 calls against chunk_attention_reference on their
    live inputs, the first `per_shape` calls of each (S, chunk) shape (the
    plain calls launch nothing), and records the shapes."""

    def __init__(self, per_shape: int = 2):
        self.per_shape, self.shapes, self.err, self.bad = per_shape, {}, 0.0, 0

    def __enter__(self):
        import spacer_tpu_torch.models.qwen25_vl.vision as vis
        from spacer_tpu_torch.ops import vit_window_attention as vwa

        self.vis, self.saved = vis, vis.chunk_attention_hsd

        def checked(q, k, v, wt, scale):
            out = self.saved(q, k, v, wt, scale)
            key = (tuple(q.shape), wt)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            if self.shapes[key] <= self.per_shape:
                ref = vwa.chunk_attention_reference(q, k, v, wt, scale)
                diff = (out.float() - ref.float()).abs()
                self.err = max(self.err, float(diff.max()))
                self.bad += not bool(
                    (diff <= BF16_TOL * (1 + ref.float().abs())).all())
            return out

        vis.chunk_attention_hsd = checked
        return self

    def __exit__(self, *exc):
        self.vis.chunk_attention_hsd = self.saved


def qwen2_vl_phase(device="cuda") -> dict:
    """Phase 10: Qwen2-VL-7B (QWEN2_VL_7B: 32 full-attention ViT blocks,
    LayerNorm, quick_gelu; the 28-layer LM) at full geometry, random bf16
    weights from seed 0.  The ViT encodes two 16-frame videos of
    QWEN2_VIDEOS (unequal grids: one K4 call per grid and block), its K4
    calls held against the plain version per shape (ChunkProbe) and the
    embeddings against the plain-attention ViT (cosine >= SLICE_COS_TOL per
    token); the ViT's ms per video alone.  Then generate_many on 2 video +
    2 text requests (K1, K4, K5; no K3: Qwen2-VL has no windowed block):
    TTFT per request, decode ms per step and the host gap between steps.
    Returns the serving path's launches."""
    from spacer_tpu_torch.data.processor import (
        MockTokenizer,
        VLProcessor,
        pack_vision_inputs,
    )
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import QWEN2_VL_7B, init_params
    from spacer_tpu_torch.models.qwen25_vl.model import encode_vision
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = QWEN2_VL_7B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    log(f"qwen2-vl init: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} "
        f"B params bf16 in {time.perf_counter() - t0:.1f} s")
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg,
                       device=device)
    rng = np.random.default_rng(10)
    convs = [[{"role": "user", "content": [
        {"type": "video", "fps": 2.0,
         "video": rng.integers(0, 256, (*shape, 3), np.uint8)},
        {"type": "text", "text": q}]}]
        for shape, q in zip(QWEN2_VIDEOS, ("how many chairs are there",
                                           "what is on the table"))]

    def pixels(conversations):
        px, grids = pack_vision_inputs(proc.process_messages(
            conversations, add_generation_prompt=True))
        return torch.as_tensor(px, device=device).to(torch.bfloat16), grids

    px, grids = pixels(convs)
    reset_launch_counts()
    with ChunkProbe() as probe, torch.no_grad():
        ve = encode_vision(params, cfg, px, grids)
        torch.cuda.synchronize()
    vit_counts = launch_counts()
    with plain_kernels(), torch.no_grad():
        ve_plain = encode_vision(params, cfg, px, grids)
    cos = torch.nn.functional.cosine_similarity(ve.float(), ve_plain.float(),
                                                dim=-1)
    per_video = []
    for conv in convs:
        px1, g1 = pixels([conv])
        with torch.no_grad():
            per_video.append((g1, median_ms(
                lambda: encode_vision(params, cfg, px1, g1))))
    log(f"qwen2-vl ViT: grids {grids}, embeddings {tuple(ve.shape)} | K4 vs "
        f"plain on live inputs: shapes (q, chunk) x calls {probe.shapes}, "
        f"max_abs_err {probe.err:.3e}, {probe.bad} outside | vs the "
        f"plain-attention ViT: cosine per token min {float(cos.min()):.5f} "
        f"median {float(cos.median()):.5f} (tol {SLICE_COS_TOL}) | ms per "
        f"video alone {[(g, round(ms, 2)) for g, ms in per_video]} | "
        f"launches {vit_counts}")
    if tuple(grids) != QWEN2_GRIDS:
        raise RuntimeError(f"qwen2-vl: video grids {grids}: phase 3 checked "
                           f"K4 at the chunks of {QWEN2_GRIDS}")
    if probe.bad or not probe.shapes or len({s for s, _ in probe.shapes}) < 2:
        raise RuntimeError(f"qwen2-vl: K4 disagrees with its plain version "
                           f"on {probe.bad} calls, shapes {probe.shapes}")
    if not float(cos.min()) >= SLICE_COS_TOL or vit_counts["K3"]:
        raise RuntimeError(f"qwen2-vl: ViT cosine min {float(cos.min())}, "
                           f"K3 launches {vit_counts['K3']}")
    del ve, ve_plain, px
    words = [f"word{i}" for i in range(5000)]
    msgs = [convs[0], [{"role": "user",
                        "content": " ".join(rng.choice(words, 200))}],
            convs[1], [{"role": "user",
                        "content": " ".join(rng.choice(words, 150))}]]
    engine = QwenEngine(cfg, params, proc)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with SliceProbe() as probe:
        t0 = time.perf_counter()
        texts = engine.generate_many(msgs, **SERVE_GEN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    ttft = sorted(t - t0 for t in probe.admitted)
    tokens = sum(probe.lengths)
    log(f"qwen2-vl serve: {len(texts)} completions, lengths {probe.lengths}, "
        f"wall {wall:.2f} s, {tokens / wall:.1f} generated tok/s | TTFT s "
        f"(generate_many start -> admission done) {[round(x, 3) for x in ttft]}"
        f" | ViT ms {[round(x, 2) for x in probe.vit_ms]} | prefill ms per "
        f"admission {[round(x, 2) for x in probe.prefill_ms]} | decode ms per "
        f"step median {statistics.median(probe.decode_ms):.2f} over "
        f"{len(probe.decode_ms)} steps, host gap between steps median "
        f"{statistics.median(probe.decode_gaps_ms()):.3f} ms | launches "
        f"{counts} | max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(probe.lengths) != len(msgs) or min(probe.lengths) < 1:
        raise RuntimeError(f"qwen2-vl: a request emitted no token: "
                           f"{probe.lengths}")
    if probe.nonfinite:
        raise RuntimeError(f"qwen2-vl: {probe.nonfinite} non-finite logits")
    if min(counts[k] for k in QWEN2_KERNELS) < 1 or counts["K3"]:
        raise RuntimeError(f"qwen2-vl: launches {counts}")
    return counts


# ---- phase 3c and phase 11: the Aria family (ARIA_25B) -------------------


def check_aria_kernels(device="cuda") -> dict:
    """Phase 3c: the kernels at the Aria path's shapes against their plain
    versions.  K1 at head_dim 72: the tower's self-attention (1, 4900, 16,
    72) under the patch mask of ARIA_IMAGE_HW (ARIA_VALID_PATCHES live keys)
    and the projector's 256 queries against those keys; K1 and K1-bwd at
    the LM's multi-head attention (group 1: Hq = Hkv = 20, head_dim 128),
    a causal left-padded prompt of 1024; K2 / K2-int8 at Hkv 20, group_q
    1, G = ARIA_TRAIN_G (phase 11b's rollout: prompt bucket
    ARIA_TRAIN_PROMPT_BUCKET, its padding) and G = 1 (phase 11a's image
    generate: ARIA_IMAGE_PROMPT_BUCKET, its padding); K5 / K5-int8 at Hkv
    20, group_q 1 (phase 11a's 4 slots, Pmax 512, Cmax 128); K6 at
    ARIA_K6_SHAPES, M = 4 (phase 11a's int4_kv serving)."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    results = {}
    # the tower and the projector: head_dim 72, no causal mask, the keys of
    # the crop's padded band masked
    Np, Hv, Dv, n_live = 4900, 16, 72, ARIA_VALID_PATCHES
    pmask = torch.zeros((1, Np), dtype=torch.bool, device=dev)
    pmask[0, :n_live] = True
    kv = (randn(1, Np, Hv, Dv), randn(1, Np, Hv, Dv))
    for tag, Sq in (("vit", Np), ("projector", ARIA_QUERIES)):
        q = randn(1, Sq, Hv, Dv)
        kw = dict(kv_mask=pmask, return_lse=True)
        results[f"K1 aria {tag}"] = compare(
            f"K1 flash_attention [aria {tag}: q (1, {Sq}, 16, 72), k/v "
            f"(1, 4900, 16, 72), {n_live} live keys]",
            lambda: fa.flash_attention(q, *kv, **kw),
            lambda: xla_attention(q, *kv, **kw),
            work=(Sq * Hv * Dv * 2 * 2 + n_live * Hv * Dv * 2 * 2
                  + Sq * Hv * 4, 4 * Dv * Hv * Sq * n_live),
            library_fn=lambda: sdpa_masked(q, *kv, pmask[:, None, None, :]))
    # the LM's attention: 20 heads of 128, group 1, causal, left-padded
    P, H, D, pad = 1024, 20, 128, 300
    mask = torch.ones((1, P), dtype=torch.bool, device=dev)
    mask[0, :pad] = False
    q, k, v = randn(1, P, H, D), randn(1, P, H, D), randn(1, P, H, D)
    dout = randn(1, P, H, D) * mask[:, :, None, None]
    kw = dict(causal=True, kv_mask=mask)
    n, pairs = P - pad, causal_pairs([P - pad])
    sdpa_mask = (torch.ones((P, P), dtype=torch.bool, device=dev).tril()[None]
                 & mask[:, None, :])[:, None]

    def live(x):
        return x[:, pad:]

    results["K1 aria lm"] = compare(
        f"K1 flash_attention [aria lm: (1, {P}, 20, 128) MHA, pad {pad}]",
        lambda: fa.flash_attention(q, k, v, **kw),
        lambda: xla_attention(q, k, v, **kw), live,
        work=(n * H * D * 2 * 4 + n * H * 4, 4 * D * H * pairs),
        library_fn=lambda: sdpa_masked(q, k, v, sdpa_mask))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lout = sdpa_masked(lq, lk, lv, sdpa_mask)

    def library():
        return torch.autograd.grad(lout, (lq, lk, lv), dout, retain_graph=True)

    q_bytes = n * H * (D * 2 + 4)
    results["K1-bwd dq aria lm"] = compare(
        f"K1-bwd dq [aria lm: (1, {P}, 20, 128) MHA]",
        lambda: fa.flash_attention_bwd_dq(*args, **kw),
        lambda: fa.attention_bwd_reference(q, k, v, dout, **kw)[0],
        rel_norm=True, library_fn=library,
        work=(q_bytes + n * H * D * 2 * 3 + n * H * D * 2 * 2,
              6 * D * H * pairs))
    results["K1-bwd dkv aria lm"] = compare(
        f"K1-bwd dk/dv [aria lm: (1, {P}, 20, 128) MHA, splits "
        f"{fa.dkv_split_count(q, k)}]",
        lambda: fa.flash_attention_bwd_dkv(*args, **kw),
        lambda: fa.attention_bwd_reference(q, k, v, dout, **kw)[1:],
        rel_norm=True, library_fn=library,
        work=(q_bytes + n * H * D * 2 * 2 + n * H * D * 2 * 4,
              8 * D * H * pairs))
    del lout, lq, lk, lv
    # K2 / K2-int8 at group 1 (phase 11b's rollout) and K5 / K5-int8
    # (phase 11a's serving slots)
    check_grouped_decode(
        randn, gen, ARIA_TRAIN_PROMPT_BUCKET, (ARIA_TRAIN_PROMPT_PAD,),
        ARIA_TRAIN_G, (1, 64, ARIA_TRAIN_NEW_TOKENS - 1), results,
        tag=" aria", C=ARIA_TRAIN_NEW_TOKENS, Hkv=20, gq=1)
    check_grouped_decode(
        randn, gen, ARIA_IMAGE_PROMPT_BUCKET, (ARIA_IMAGE_PROMPT_PAD,), 1,
        (1, 16, ARIA_NEW_TOKENS - 1), results, tag=" aria image",
        C=ARIA_NEW_TOKENS, Hkv=20, gq=1)
    results.update(check_ragged_decode(
        randn, gen, " aria", 512, 128, [230, 212, 251, 198], [32, 17, 1, 9],
        [0, 40, 100, 127], Hkv=20, gq=1))
    results.update(check_int4_matmul(gen, ARIA_K6_SHAPES, (4,), tag=" aria"))
    return results


def tp_k6_shapes(tp: int) -> tuple:
    """The (K, N) of a tp rank's int4 decode products at the 7B widths:
    q, k / v, o, gate / up, down and lm_head, the column-parallel ones'
    N and the row-parallel ones' K cut by tp."""
    return ((3584, 3584 // tp), (3584, 512 // tp), (3584 // tp, 3584),
            (3584, 18944 // tp), (18944 // tp, 3584), (3584, 152064 // tp))


def check_tp_kernels(device="cuda") -> dict:
    """Phase 3d: every kernel against its plain version at the shapes one
    rank of a tp-2 and a tp-4 Qwen2.5-VL-7B runs (TP_SIZES): K1 and K1-bwd
    on phase 5's update (H 14 / 7 query and Hkv 2 / 1 KV heads), K2 and
    K2-int8 on its rollout (Hkv 2 / 1), K5 and K5-int8 on phase 4's slots
    (Hkv 2 / 1), K3 and K4 on phase 4's video (8 / 4 ViT heads), K6 (fused
    dense_q4) at the sliced products of tp_k6_shapes, M = 4 and 16.
    Results carry a " tp=N" suffix; none of them enters the kernels line."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    tc, vcfg = QWEN25_VL_7B.text, QWEN25_VL_7B.vision
    layout = vision_layout([(8, 16, 30)], vcfg)
    results = {}
    for tp in TP_SIZES:
        sfx = f" tp={tp}"
        H, Hkv = tc.num_heads // tp, tc.num_kv_heads // tp
        t0 = time.perf_counter()
        check_k1_passes(randn, gen, TRAIN_PROMPT_BUCKET, (TRAIN_PROMPT_PAD,),
                        results, H=H, Hkv=Hkv, suffix=sfx)
        check_grouped_decode(randn, gen, TRAIN_PROMPT_BUCKET,
                             (TRAIN_PROMPT_PAD, TRAIN_PROMPT_PAD), TRAIN_G,
                             (1, TRAIN_NEW_TOKENS - 1), results, tag=sfx,
                             Hkv=Hkv)
        results.update(check_ragged_decode(randn, gen, sfx, 1024,
                                           *RAGGED_CASES[""], Hkv=Hkv))
        results.update(check_vit_kernels(
            randn, dev, layout, vcfg.num_heads // tp, vcfg.head_dim,
            ((f"K4{sfx}", layout.seq_len, layout.full_chunk),), tag=sfx))
        results.update(check_int4_matmul(gen, tp_k6_shapes(tp), (4, 16),
                                         tag=sfx, fused_only=True))
        log(f"phase 3d tp={tp}: {time.perf_counter() - t0:.1f} s")
    return results


def aria_tp_k6_shapes(tp: int) -> tuple:
    """The (K, N) of a tp rank's int4 decode products at ARIA_25B's widths:
    q / k / v and o, the shared experts' gate / up and down, lm_head, the
    column-parallel ones' N and the row-parallel ones' K cut by tp (the
    shared down_proj's K is 832 at tp 4: one K-block with a half chunk)."""
    return ((2560, 2560 // tp), (2560 // tp, 2560), (2560, 3328 // tp),
            (3328 // tp, 2560), (2560, 100352 // tp))


def check_aria_tp_kernels(device="cuda") -> dict:
    """Phase 3e: every kernel of the Aria path against its plain version
    at the shapes one rank of a tp-2 and a tp-4 ARIA_25B runs (TP_SIZES):
    K1 at head_dim 72 on the tower (16 / tp heads, phase 11's crop of 4900
    patches, ARIA_VALID_PATCHES live keys); K1 and K1-bwd on phase 11b's
    update (20 / tp query and KV heads, group 1), K2 and K2-int8 on its
    rollout (Hkv 20 / tp, group_q 1), K5 and K5-int8 on phase 11a's slots
    (Hkv 20 / tp, group_q 1), K6 (fused dense_q4) at aria_tp_k6_shapes, M
    = 4 and 16.  Results carry an " aria tp=N" suffix; none of them enters
    the kernels line."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    Np, Dv, n_live = 4900, 72, ARIA_VALID_PATCHES
    pmask = torch.zeros((1, Np), dtype=torch.bool, device=dev)
    pmask[0, :n_live] = True
    results = {}
    for tp in TP_SIZES:
        sfx = f" aria tp={tp}"
        t0 = time.perf_counter()
        Hv, H = 16 // tp, 20 // tp
        q, k, v = randn(1, Np, Hv, Dv), randn(1, Np, Hv, Dv), \
            randn(1, Np, Hv, Dv)
        kw = dict(kv_mask=pmask, return_lse=True)
        results[f"K1 vit{sfx}"] = compare(
            f"K1 flash_attention [aria vit{sfx}: (1, {Np}, {Hv}, 72), "
            f"{n_live} live keys]",
            lambda: fa.flash_attention(q, k, v, **kw),
            lambda: xla_attention(q, k, v, **kw),
            work=(Np * Hv * Dv * 2 * 2 + n_live * Hv * Dv * 2 * 2
                  + Np * Hv * 4, 4 * Dv * Hv * Np * n_live),
            library_fn=lambda: sdpa_masked(q, k, v, pmask[:, None, None, :]))
        del q, k, v
        check_k1_passes(randn, gen, ARIA_TRAIN_PROMPT_BUCKET,
                        (ARIA_TRAIN_PROMPT_PAD,), results, H=H, Hkv=H,
                        G=ARIA_TRAIN_G, C=ARIA_TRAIN_NEW_TOKENS, suffix=sfx)
        check_grouped_decode(
            randn, gen, ARIA_TRAIN_PROMPT_BUCKET, (ARIA_TRAIN_PROMPT_PAD,),
            ARIA_TRAIN_G, (1, ARIA_TRAIN_NEW_TOKENS - 1), results, tag=sfx,
            C=ARIA_TRAIN_NEW_TOKENS, Hkv=H, gq=1)
        results.update(check_ragged_decode(
            randn, gen, sfx, 512, 128, [230, 212, 251, 198], [32, 17, 1, 9],
            [0, 40, 100, 127], Hkv=H, gq=1))
        results.update(check_int4_matmul(gen, aria_tp_k6_shapes(tp), (4, 16),
                                         tag=sfx, fused_only=True))
        log(f"phase 3e tp={tp}: {time.perf_counter() - t0:.1f} s")
    return results


def aria_param_count(cfg) -> int:
    """Parameters of an Aria config, reckoned from its widths."""
    t, v = cfg.text, cfg.vision
    D, Dh, E, I = t.hidden_size, t.head_dim, t.moe_num_experts, \
        t.intermediate_size
    Is = I * t.moe_num_shared_experts
    layer = (2 * D + D * (t.num_heads + 2 * t.num_kv_heads) * Dh
             + t.num_heads * Dh * D + D * E + E * 3 * D * I + 3 * D * Is)
    lm = t.num_layers * layer + D + t.vocab_size * D * (
        1 if t.tie_word_embeddings else 2)
    Dv, Iv = v.hidden_size, v.intermediate_size
    vit = (v.num_channels * v.patch_size ** 2 * Dv + Dv
           + v.num_patches_per_side ** 2 * Dv + 2 * Dv
           + v.num_layers * (4 * Dv + 4 * (Dv * Dv + Dv) + 2 * Dv * Iv + Iv
                             + Dv))
    proj = (cfg.max_projector_queries * Dv + 3 * Dv * Dv + 3 * Dv * Dv
            + 3 * Dv + 2 * (Dv * Dv + Dv) + 6 * Dv
            + Dv * t.hidden_size + t.hidden_size ** 2)
    return lm + vit + proj


def aria_image(root: pathlib.Path) -> str:
    """A synthetic ARIA_IMAGE_HW PNG (smooth gradients and noise, seed 0),
    written under `root`; -> its path."""
    from PIL import Image

    h, w = ARIA_IMAGE_HW
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)],
                   -1) + rng.integers(0, 40, (h, w, 3))
    root.mkdir(parents=True, exist_ok=True)
    path = root / "aria_scene.png"
    # written whole under another name, then renamed: ranks that write it
    # at once never read a partial file
    tmp = root / f"aria_scene.{os.getpid()}.png"
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(tmp)
    os.replace(tmp, path)
    return str(path)


class SampleLog:
    """Observes Sampler.generate: records the logits of every sampled step
    (the prefill's last position, then each decode step) and, with
    `replay`, returns those tokens instead of sampling; times the prefill
    and each decode step (synchronised)."""

    def __init__(self, replay=None):
        import spacer_tpu_torch.sampler.sampler as sm

        self.sm, self.replay = sm, replay
        self.logits, self.tokens = [], []
        self.prefill_ms, self.decode_ms = [], []
        self.saved = (sm.sample_logits, sm.lm_forward, sm.lm_decode_step_split)

    @staticmethod
    def _timed(sink, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def __enter__(self):
        sample, forward, step = self.saved

        def recorded(logits, *a, **kw):
            tokens = sample(logits, *a, **kw)
            if self.replay is not None:
                tokens = self.replay[len(self.tokens)]
            self.logits.append(logits.float())
            self.tokens.append(tokens)
            return tokens

        self.sm.sample_logits = recorded
        self.sm.lm_forward = self._timed(self.prefill_ms, forward)
        self.sm.lm_decode_step_split = self._timed(self.decode_ms, step)
        return self

    def __exit__(self, *exc):
        (self.sm.sample_logits, self.sm.lm_forward,
         self.sm.lm_decode_step_split) = self.saved


def logits_cosine(tag, a_steps, b_steps, note="") -> float:
    """Per sampled step, the least row cosine of two runs' logits; fails
    below SLICE_COS_TOL.  -> the least over the steps."""
    cos = torch.stack([torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
                       for a, b in zip(a_steps, b_steps)])
    log(f"{tag} vs plain versions: logits cosine min {float(cos.min()):.5f} "
        f"median {float(cos.median()):.5f} over {len(cos)} sampled steps "
        f"(tol {SLICE_COS_TOL}){note}")
    if len(a_steps) != len(b_steps) or not float(cos.min()) >= SLICE_COS_TOL:
        raise RuntimeError(f"{tag}: the kernel path's logits disagree with "
                           "the plain versions' path")
    return float(cos.min())


def grouped_mm_f32(x, w, group_sizes):
    """The grouped product in JAX's order (ragged_dot with
    preferred_element_type f32): bf16 operands, f32 sums, an f32 result;
    one f32 matmul per group on the widened operands (TF32 is off)."""
    out, start = [], 0
    for g, n in enumerate(group_sizes.tolist()):
        out.append(torch.matmul(x[start:start + n].float(), w[g].float()))
        start += n
    return torch.cat(out, dim=0)


def moe_decode_ms(params, cfg, device="cuda") -> dict:
    """The MoE feed-forward of one ARIA_25B layer: moe_mlp on M tokens (1:
    the image generate at G = 1; 4: the serving slots; 8: phase 11b's
    rollout; ARIA_IMAGE_PROMPT_BUCKET: a prefill).  Its output is held
    against the same moe_mlp with JAX's f32 expert sums (grouped_mm_f32;
    torch._grouped_mm on the card rounds each product to bf16):
    |out - ref| <= BF16_TOL * (1 + |ref|) and ||out - ref|| <=
    GRAD_REL_TOL * ||ref||; the routes are the same (the router runs in f32
    on the same x).  Times the grouped products (torch._grouped_mm) against
    the per-expert loop over the same sorted rows (moe.grouped_mm_reference,
    which reads the group sizes on the host).  moe_mlp must take no host
    sync (CUDA's sync debug mode raises on one).  -> {M: (max_abs_err,
    rel-norm)}."""
    from spacer_tpu_torch.ops import moe

    mlp = params["model"]["layers"][0]["mlp"]
    gen = torch.Generator(device=device).manual_seed(3)
    gaps = {}
    for M in (1, 4, 8, ARIA_IMAGE_PROMPT_BUCKET):
        x = torch.randn((M, 1, cfg.text.hidden_size), generator=gen,
                        device=device).to(torch.bfloat16)
        with torch.no_grad():
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = moe.moe_mlp(mlp, x, topk=cfg.text.moe_topk).float()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            saved = moe.grouped_mm
            moe.grouped_mm = grouped_mm_f32
            try:
                ref = moe.moe_mlp(mlp, x, topk=cfg.text.moe_topk).float()
            finally:
                moe.grouped_mm = saved
            diff = (out - ref).abs()
            err = float(diff.max())
            rel = float(diff.norm() / ref.norm().clamp_min(1e-30))
            gaps[M] = (err, rel)
            if not (bool(torch.isfinite(out).all())
                    and bool((diff <= BF16_TOL * (1 + ref.abs())).all())
                    and rel <= GRAD_REL_TOL):
                raise RuntimeError(
                    f"aria moe_mlp M={M}: the grouped products disagree with "
                    f"JAX's f32 expert sums: max_abs_err {err}, rel-norm {rel}")
            grouped = median_ms(lambda: moe.moe_mlp(mlp, x, topk=cfg.text.moe_topk))
            dev_ms = device_ms(lambda: moe.moe_mlp(mlp, x,
                                                   topk=cfg.text.moe_topk))
            saved = moe.grouped_mm
            moe.grouped_mm = moe.grouped_mm_reference
            try:
                loop = median_ms(lambda: moe.moe_mlp(mlp, x,
                                                     topk=cfg.text.moe_topk))
            finally:
                moe.grouped_mm = saved
        log(f"aria moe_mlp one layer, M={M} tokens x top-"
            f"{cfg.text.moe_topk} of {cfg.text.moe_num_experts}: grouped_mm "
            f"{grouped:.4f} ms (device "
            + ("not measured" if dev_ms is None else f"{dev_ms:.4f}")
            + f" ms) | per-expert loop {loop:.4f} ms | vs JAX's f32 expert "
            f"sums: max_abs_err {err:.3e} (tol {BF16_TOL:.0e} * (1 + |ref|)), "
            f"rel-norm {rel:.3e} (tol {GRAD_REL_TOL:.0e}), |ref| max "
            f"{float(ref.abs().max()):.3e}")
    return gaps


def aria_serve_phase(device="cuda") -> dict:
    """Phase 11a: Aria at full ARIA_25B geometry (random bf16 weights, seed
    0).  One ARIA_IMAGE_HW PNG through AriaProcessor (one 980-pixel crop,
    its padded band masked) and Sampler.generate at G = 1,
    ARIA_NEW_TOKENS greedy tokens (K1 at head_dim 72 in the tower and the
    projector, K1 at the prefill, K2 at group 1), replayed through the
    plain versions with the same tokens: every sampled step's logits at
    cosine >= SLICE_COS_TOL.  Then four text requests through
    QwenEngine.generate_many (4 slots), bf16 (K1, K5) and int4_kv (K1,
    K5-int8, K6), each replayed likewise (serve_run).  Prints the tower +
    projector ms per image, prefill ms, decode ms per step, tok/s, the MoE
    layer's ms at decode and the peaks.  Returns the launches per path."""
    from spacer_tpu_torch.models.aria import ARIA_25B, init_params
    from spacer_tpu_torch.models.registry import aria_positions, get_family
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.sampler import Sampler

    cfg, family = ARIA_25B, get_family("aria")
    n = aria_param_count(cfg)
    log(f"aria 25B: reckoned {n / 1e9:.2f} B params, {2 * n / 1e9:.1f} GB in "
        f"bf16, before the caches (card: "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    got = sum(t.numel() for t in _leaves(params))
    log(f"aria 25B init: {got / 1e9:.2f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s | max_memory_allocated "
        f"{gib(torch.cuda.max_memory_allocated())}")
    if got != n:
        raise RuntimeError(f"aria: {got} params, reckoned {n}")
    proc = family.make_processor(family.mock_tokenizer(cfg.text.vocab_size),
                                 cfg)
    root = pathlib.Path(__file__).resolve().parent / "build" / "smoke_aria"
    image = aria_image(root)
    enc = proc.process_messages([[{"role": "user", "content": [
        {"type": "image", "image": image},
        {"type": "text", "text": "how many chairs are in the room"}]}]])
    vk, _ = family.pack_vision(enc)
    live = int(enc["patch_mask"].sum())
    log(f"aria image {ARIA_IMAGE_HW}: crops {tuple(enc['pixel_values'].shape)}"
        f", live patches {live} of {enc['patch_mask'].size}, prompt "
        f"{enc['input_ids'].shape[1]} tokens")
    if live != ARIA_VALID_PATCHES or enc["pixel_values"].shape[0] != 1:
        raise RuntimeError(f"aria: {live} live patches, phase 3c checked K1 "
                           f"at {ARIA_VALID_PATCHES}")
    with torch.no_grad():
        vit_ms = [median_ms(lambda: family.encode_vision(params, cfg, vk,
                                                         None))]
    pos, deltas = aria_positions(cfg, enc["input_ids"], enc["attention_mask"])
    sampler = Sampler(cfg, eos_token_id=proc.eos_token_id,
                      pad_token_id=proc.pad_token_id)
    kw = dict(position_ids=pos, deltas=deltas, vision_kwargs=vk,
              num_generations=1, max_new_tokens=ARIA_NEW_TOKENS,
              temperature=0.0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with RouteLog() as routes, DecodeProbe() as probe, SampleLog() as run:
        t0 = time.perf_counter()
        out = sampler.generate(enc["input_ids"], enc["attention_mask"],
                               params, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    k2_prefix = {P for _, P, _ in probe.k2_shapes}
    pad = ARIA_IMAGE_PROMPT_BUCKET - enc["input_ids"].shape[1]
    log(f"aria image generate: K2 vs plain on live inputs: "
        f"{len(probe.k2_err)} calls at (q shape, P, T) "
        f"{sorted(probe.k2_shapes)}, prompt pad {pad}, max_abs_err "
        f"{max(probe.k2_err, default=float('nan')):.3e}, {probe.k2_bad} "
        f"outside (tol {BF16_TOL:.0e} * (1 + |ref|))")
    if not probe.k2_err or probe.k2_bad or probe.nonfinite:
        raise RuntimeError(f"aria image: K2 disagrees with its plain version "
                           f"on {probe.k2_bad} of {len(probe.k2_err)} live "
                           f"calls, {probe.nonfinite} non-finite logits")
    if k2_prefix != {ARIA_IMAGE_PROMPT_BUCKET} or pad != ARIA_IMAGE_PROMPT_PAD:
        raise RuntimeError(f"aria image: K2 prefix {k2_prefix} pad {pad}: "
                           f"phase 3c checked K2 at {ARIA_IMAGE_PROMPT_BUCKET}"
                           f" pad {ARIA_IMAGE_PROMPT_PAD}")
    log(f"aria image generate: {int(out.lengths[0])} tokens in {wall:.2f} s "
        f"({out.lengths.sum() / wall:.1f} tok/s) | tower + projector "
        f"{vit_ms[0]:.2f} ms per image | prefill ms {run.prefill_ms} | decode "
        f"ms per step median {statistics.median(run.decode_ms):.2f} over "
        f"{len(run.decode_ms)} steps | launches {counts} | "
        f"max_memory_allocated {gib(torch.cuda.max_memory_allocated())}")
    if (counts["K1"] != cfg.vision.num_layers + 1 + cfg.text.num_layers
            or counts["K2"] < 1):
        raise RuntimeError(f"aria image: launches {counts}: expected K1 "
                           f"{cfg.vision.num_layers} + 1 (tower, projector) + "
                           f"{cfg.text.num_layers} (prefill) and K2")
    with plain_kernels(), RouteLog(replay=routes.idx) as ref_routes, \
            SampleLog(replay=run.tokens) as ref:
        sampler.generate(enc["input_ids"], enc["attention_mask"], params, **kw)
    if launch_counts() != counts:
        raise RuntimeError("aria: the plain replay launched a kernel")
    logits_cosine("aria image generate", run.logits, ref.logits,
                  ref_routes.note())
    run = ref = routes = None
    paths = {"aria image": counts}

    rng = np.random.default_rng(11)
    words = [f"word{i}" for i in range(5000)]
    msgs = [[{"role": "user", "content": " ".join(rng.choice(words, nw))}]
            for nw in (200, 150, 190, 120)]
    gen_kw = dict(max_new_tokens=ARIA_NEW_TOKENS, temperature=0.0, slots=4)
    for quant, kernels in ((None, ARIA_SERVE_KERNELS),
                           ("int4_kv", ARIA_SERVE_INT4_KV_KERNELS)):
        counts, _ = serve_run(cfg, params, proc, msgs, quant, kernels,
                              gen_kw=gen_kw, grid=None, tag="aria serve")
        paths[f"aria serve {quant or 'bf16'}"] = counts
    moe_decode_ms(params, cfg, device)
    return paths


def aria_train_phase(device="cuda") -> dict:
    """Phase 11b: SGRLVRTrainer.train with the Aria family at ARIA_25B's
    widths, the LM cut to ARIA_TRAIN_LM_LAYERS of 28 layers (all 64 experts
    a layer, the full 27-layer tower and the projector), random bf16
    weights from seed 0: one ARIA_IMAGE_HW image row, G = ARIA_TRAIN_G
    completions of up to ARIA_TRAIN_NEW_TOKENS, int8_kv rollouts (K2-int8
    held against its plain version on live inputs), beta 0.04, int8
    moments, remat, two optimizer steps (the update through K1 at 72 and
    128, K1-bwd at 128 and the MoE's grouped backward).  The first update
    is replayed with plain attention on LM layer 0's, tower layer 0's and
    the projector's tensors: each group's gradient cosine >= GRAD_COS_TOL.
    Returns the path's launches."""
    from spacer_tpu_torch.models.aria import ARIA_25B, init_params
    from spacer_tpu_torch.models.registry import get_family
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.rewards import accuracy_reward, format_reward
    from spacer_tpu_torch.train.step import param_leaves
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    cfg = dataclasses.replace(ARIA_25B, text=dataclasses.replace(
        ARIA_25B.text, num_layers=ARIA_TRAIN_LM_LAYERS))
    family = get_family("aria")
    n = aria_param_count(cfg)
    log(f"aria train: reckoned {n / 1e9:.2f} B params: bf16 params, the "
        f"reference copy and bf16 grads {3 * 2 * n / 1e9:.1f} GB + int8 "
        f"moments {2 * n / 1e9:.1f} GB, before activations")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    names = [nm for nm, _ in param_leaves(params)]
    log(f"aria train init: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f}"
        f" B params bf16, LM {ARIA_TRAIN_LM_LAYERS} layers, in "
        f"{time.perf_counter() - t0:.1f} s")
    root = pathlib.Path(__file__).resolve().parent / "build" / "smoke_aria"
    row = {"problem": "How many chairs are in the room?",
           "problem_type": "numerical", "solution": "<answer>3</answer>",
           "path": aria_image(root), "data_type": "image",
           "data_source": "synthetic", "problem_id": 0,
           "prompt": [{"role": "user", "content": [
               {"type": "image"},
               {"type": "text", "text": "How many chairs are in the room?"}]}]}
    out_dir = str(root / "train")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = SGRLVRConfig(
        num_generations=ARIA_TRAIN_G,
        max_completion_length=ARIA_TRAIN_NEW_TOKENS, temperature=1.0,
        top_p=0.95, beta=0.04, moment_dtype="int8", max_steps=2,
        num_train_epochs=2, logging_steps=1, save_steps=10 ** 9,
        skip_failed_steps=False, output_dir=out_dir, seed=0)
    trainer = SGRLVRTrainer(
        cfg, params, family.make_processor(
            family.mock_tokenizer(cfg.text.vocab_size), cfg),
        [synthetic_reward, accuracy_reward, format_reward], [row], args)
    step_fn, steps, extra = trainer.step_fn, [], {}

    def select(name):
        return name.startswith(("model/layers/0/", "visual/encoder/0/",
                                "projector/"))

    def spy(params, ref_params, opt_state, batch, **kw):
        if not steps:
            e, _ = replay_grads(grpo_run(step_fn, params, batch, kw), names,
                                tag="aria train", select=select)
            extra.update(e)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, ref_params, opt_state, batch, **kw)
        torch.cuda.synchronize()
        steps.append(dict({k: float(v) for k, v in out[2].items()},
                          update_s=time.perf_counter() - t,
                          prompt_len=batch["prompt_ids"].shape[1],
                          prompt_pad=int((batch["prompt_mask"] == 0).sum())))
        return out

    spy.ref_logps_fn = step_fn.ref_logps_fn
    trainer.step_fn = spy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with DecodeProbe() as probe:
        trainer.train()
        torch.cuda.synchronize()
    counts = {k: c - extra.get(k, 0) for k, c in launch_counts().items()}
    with open(pathlib.Path(out_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    for i, (st, rec) in enumerate(zip(steps, records)):
        log(f"aria train step {i + 1}: loss {st['loss']:.6e} kl "
            f"{st['kl']:.6e} grad_norm {st['grad_norm']:.6e} | rollout "
            f"{rec['time/rollout_s']:.2f} s, update {st['update_s']:.2f} s | "
            f"prompt bucket {st['prompt_len']} (pad {st['prompt_pad']}), "
            f"mean completion length {rec['completion_length']:.1f}")
    log(f"aria train: rollout decode ms per step median "
        f"{statistics.median(probe.decode_ms()):.2f} | K2-int8 vs plain on "
        f"live inputs: {len(probe.k2_err)} calls at (q shape, P, T) "
        f"{sorted(probe.k2_shapes)}, max_abs_err "
        f"{max(probe.k2_err, default=float('nan')):.3e}, {probe.k2_bad} "
        f"outside | max_memory_allocated "
        f"{gib(torch.cuda.max_memory_allocated())} | launches {counts}")
    if trainer.global_step != 2 or len(steps) != 2:
        raise RuntimeError(f"aria: expected 2 optimizer steps, got {len(steps)}")
    for st in steps:
        if (st["prompt_len"], st["prompt_pad"]) != (ARIA_TRAIN_PROMPT_BUCKET,
                                                    ARIA_TRAIN_PROMPT_PAD):
            raise RuntimeError(
                f"aria: prompt bucket {st['prompt_len']} pad "
                f"{st['prompt_pad']}: phase 3c checked K2 at "
                f"{ARIA_TRAIN_PROMPT_BUCKET} pad {ARIA_TRAIN_PROMPT_PAD}")
        if not all(math.isfinite(st[k]) for k in ("loss", "kl", "grad_norm")):
            raise RuntimeError(f"aria: non-finite step metrics {st}")
    if not probe.k2_err or probe.k2_bad or probe.nonfinite:
        raise RuntimeError(f"aria: K2-int8 disagrees with its plain version "
                           f"on {probe.k2_bad} of {len(probe.k2_err)} live "
                           f"calls, {probe.nonfinite} non-finite logits")
    if min(counts[k] for k in ARIA_TRAIN_KERNELS) < 1:
        raise RuntimeError(f"aria: a kernel of the training path was never "
                           f"launched: {counts}")
    shutil.rmtree(root, ignore_errors=True)
    return counts


# Phase 12: the data x fsdp path (spacer_tpu_torch/parallel) at world 1 over
# NCCL: the sharded SGRLVRTrainer against the unsharded one on the same
# params, rows and seed at 7B widths, the LM cut to FSDP_LM_LAYERS layers.
FSDP_LM_LAYERS = 4
FSDP_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K2-int8", "K3", "K4")
# The collectives phase 12's sharded run must make.
FSDP_COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce",
                    "object_gather", "object_broadcast")
# --world N (a development run on N cards; never by default): full depth,
# FSDP_WORLD_ROWS video rows per step (rollout_batch_size), step 1 against
# a world-1 reference of the same rows and completions: the loss within
# FSDP_WORLD_LOSS_RTOL, every gradient group's cosine >= FSDP_WORLD_COS_TOL
# over the gradients of LM layers FSDP_WORLD_LAYERS, ViT blocks
# FSDP_WORLD_BLOCKS and every tensor outside the layer lists (the whole
# model's 16.6 GB of bf16 gradients would be written and read back).
# phase 13's tp collectives (counted at world 1, where none is issued)
TP_COLLECTIVES = ("tp_all_reduce", "tp_all_gather", "tp_max")
FSDP_WORLD_ROWS = 4
FSDP_WORLD_LOSS_RTOL, FSDP_WORLD_COS_TOL = 1e-3, 0.999
FSDP_WORLD_LAYERS, FSDP_WORLD_BLOCKS = (0, 13, 27), (0, 31)


class GradTap:
    """Wraps an optimizer's apply: sink(update, grads, gnorm) sees every
    update's gradients (this rank's blocks of sharded tensors) before they
    are applied."""

    def __init__(self, tx, sink):
        self.apply, self.sink, self.n = tx.apply, sink, 0
        tx.apply = self

    def __call__(self, grads, state, params, **kw):
        self.sink(self.n, grads, kw.get("gnorm"))
        self.n += 1
        return self.apply(grads, state, params, **kw)


def _full_view(t, leaf):
    """A Shard's blocks as the tensor's own shape (at fsdp 1 the blocks
    hold the whole tensor); any other tensor as it is."""
    from spacer_tpu_torch.parallel import fsdp

    if isinstance(leaf, fsdp.Shard):
        return t.reshape(-1)[:leaf.numel].view(leaf.shape)
    return t


def fsdp_train_run(cfg, out_dir, mesh=None, ref=None, device="cuda",
                   make=None, **trainer_kw) -> dict:
    """Two SGRLVRTrainer.train steps (make_trainer's slice, or `make`'s;
    `trainer_kw` go to it) with or without `mesh`.  Without `ref` the completions, step
    metrics, every update's gradients, the final params and the int8
    moments are kept on the host; with `ref` (that record) each is held
    bitwise against it as it comes, and the names of the tensors that
    differ are kept."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel import fsdp, multihost
    from spacer_tpu_torch.train.step import param_leaves

    trainer, names = (make or make_trainer)(cfg, device, 2, out_dir,
                                            mesh=mesh, **trainer_kw)
    raw = fsdp.raw_leaves(trainer.params)
    rec = {"rollouts": [], "steps": [], "grads": [], "grad_bad": [],
           "check_s": []}

    def sink(update, grads, gnorm):
        torch.cuda.synchronize()
        t = time.perf_counter()
        check(update, grads)
        torch.cuda.synchronize()
        rec["check_s"].append(time.perf_counter() - t)

    def check(update, grads):
        gs = [_full_view(g, leaf) for g, leaf in zip(grads, raw)]
        if ref is None:
            rec["grads"].append([g.detach().cpu() for g in gs])
        else:
            want = ref["grads"][update]
            rec["grad_bad"].append([
                names[i] for i, g in enumerate(gs)
                if not torch.equal(g, want[i].to(g.device))])

    GradTap(trainer.tx, sink)
    generate = trainer.sampler.generate

    def recorded(*a, **kw):
        out = generate(*a, **kw)
        rec["rollouts"].append(out.sequences.copy())
        return out

    trainer.sampler.generate = recorded
    step_fn = trainer.step_fn

    def spy(params, ref_params, opt_state, batch, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, ref_params, opt_state, batch, **kw)
        torch.cuda.synchronize()
        # the gradient check inside the update is not the update's time
        rec["steps"].append(dict(
            {k: float(out[2][k]) for k in ("loss", "kl", "grad_norm")},
            update_s=time.perf_counter() - t - rec["check_s"][-1]))
        return out

    spy.ref_logps_fn = step_fn.ref_logps_fn
    trainer.step_fn = spy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    multihost.reset_collective_stats()
    multihost.time_collectives(mesh is not None)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    rec["wall"] = time.perf_counter() - t0
    rec["counts"] = launch_counts()
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["collectives"] = multihost.collective_stats()
    multihost.time_collectives(False)
    with open(pathlib.Path(out_dir) / "metrics.jsonl") as f:
        rec["rollout_s"] = [json.loads(line)["time/rollout_s"] for line in f]
    params = fsdp.full_params(trainer.params)
    state = fsdp.state_to_full(trainer.opt_state, trainer.params)
    finals = [t.detach() for _, t in param_leaves(params)]
    moments = [x for pair in state.mu + state.nu for x in pair]
    if ref is None:
        rec["params"] = [t.cpu() for t in finals]
        rec["moments"] = [x.cpu() for x in moments]
    else:
        ulp = []
        rec["param_bad"] = []
        for n, t, want in zip(names, finals, ref["params"]):
            want = want.to(t.device)
            if not torch.equal(t, want):
                rec["param_bad"].append(n)
                a, b = t.float(), want.float()
                ulp.append(bool(((a - b).abs() <= torch.maximum(
                    a.abs(), b.abs()) * 2.0 ** -7).all()))
        rec["param_one_ulp"] = all(ulp)
        rec["moment_bad"] = sum(not torch.equal(x, w.to(x.device))
                                for x, w in zip(moments, ref["moments"]))
    rec["n_tensors"] = len(names)
    del trainer, params, state, finals, moments
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _collective_line(stats: dict, steps: int) -> str:
    return ", ".join(
        f"{k} {v['calls'] / steps:.0f} calls {v['bytes'] / steps / 1e9:.3f} "
        f"GB" + (f" {v['ms'] / steps:.1f} ms" if "ms" in v else "")
        for k, v in sorted(stats.items()))


def sharded_run_problems(plain, sharded, name, collectives, kernels) -> list:
    """Log two fsdp_train_run records (unsharded, then over a world-1 mesh)
    and return what breaks phase 12's gate: completions, losses, kl and
    every update's gradients, the final params and int8 moments bitwise
    (grad_norm within rel 1e-6; where the clip scaled a step and the norms
    differ, the params within one bf16 ulp), every collective kind of
    `collectives` made and every kernel of `kernels` launched."""
    for tag, r in (("unsharded", plain), ("sharded", sharded)):
        for i, st in enumerate(r["steps"]):
            log(f"{name} {tag} step {i + 1}: loss {st['loss']!r} kl "
                f"{st['kl']!r} grad_norm {st['grad_norm']!r} | rollout "
                f"{r['rollout_s'][i]:.2f} s update {st['update_s']:.2f} s "
                f"(the gradient check's {r['check_s'][i]:.2f} s apart)")
        log(f"{name} {tag}: wall {r['wall']:.1f} s for 2 steps, checks "
            f"included; max_memory_allocated {gib(r['peak'])}")
    a, b = plain["steps"][1], sharded["steps"][1]
    log(f"{name} step 2 (both warm), sharded vs unsharded: rollout "
        f"{sharded['rollout_s'][1]:.2f} vs {plain['rollout_s'][1]:.2f} s, "
        f"update {b['update_s']:.2f} vs {a['update_s']:.2f} s")
    log(f"{name} sharded: collectives per step: "
        + _collective_line(sharded["collectives"], 2))
    same_rollouts = (len(plain["rollouts"]) == len(sharded["rollouts"]) == 2
                     and all(np.array_equal(a, b) for a, b in
                             zip(plain["rollouts"], sharded["rollouts"])))
    clipped = any(st["grad_norm"] >= 5.0 for st in plain["steps"])
    norms_equal = all(a["grad_norm"] == b["grad_norm"]
                      for a, b in zip(plain["steps"], sharded["steps"]))
    log(f"{name} world 1 vs unsharded: completions equal {same_rollouts}, "
        f"losses {[s['loss'] for s in sharded['steps']]} vs "
        f"{[s['loss'] for s in plain['steps']]}, grad_norm bitwise "
        f"{norms_equal} (clip active: {clipped}), gradients differing "
        f"{[len(b) for b in sharded['grad_bad']]} of {plain['n_tensors']} "
        f"per update, params differing {len(sharded['param_bad'])}, "
        f"int8 moment tensors differing {sharded['moment_bad']}")
    problems = []
    if not same_rollouts:
        problems.append("completions differ")
    for a, b in zip(plain["steps"], sharded["steps"]):
        if a["loss"] != b["loss"] or a["kl"] != b["kl"]:
            problems.append(f"loss/kl {b} vs {a}")
        if abs(a["grad_norm"] - b["grad_norm"]) > 1e-6 * abs(a["grad_norm"]):
            problems.append(f"grad_norm {b['grad_norm']} vs {a['grad_norm']}")
    if len(sharded["grad_bad"]) != 2 or any(sharded["grad_bad"]):
        problems.append(f"gradients differ: {sharded['grad_bad']}")
    if sharded["param_bad"] and not (clipped and not norms_equal
                                     and sharded["param_one_ulp"]):
        problems.append(f"params differ: {sharded['param_bad'][:8]}")
    if sharded["moment_bad"]:
        problems.append(f"{sharded['moment_bad']} moment tensors differ")
    missing = [k for k in collectives
               if not sharded["collectives"].get(k, {}).get("calls")]
    if missing:
        problems.append(f"no {missing} collective in the sharded run")
    counts = sharded["counts"]
    log(f"{name} sharded: launches {counts}")
    if min(counts[k] for k in kernels) < 1:
        problems.append(f"a kernel of the path was never launched: {counts}")
    return problems


_STORES = []


def world1_env():
    """torchrun's environment for rank 0 of a world of 1, its rendezvous a
    store this process holds (multihost.local_store)."""
    from spacer_tpu_torch.parallel import multihost

    _STORES.append(multihost.local_store())
    os.environ.update(multihost.store_env(_STORES[-1], 0, 1))


def fsdp_phase(device="cuda") -> dict:
    """Phase 12: world 1 over NCCL through parallel.multihost.initialize()
    (torchrun's environment for rank 0 of 1), create_mesh({"data": 1,
    "fsdp": 1, "tp": 1}) and shard_params; two SGRLVRTrainer steps at
    Qwen2.5-VL-7B widths with the LM cut to FSDP_LM_LAYERS layers, the
    full ViT, one 16-frame video row, G = TRAIN_G, int8_kv rollouts,
    unsharded and then sharded on the same params, rows and seed.  Gate:
    completions, losses, kl, every update's gradients, the final params and
    int8 moments bitwise equal (at world 1 every collective is a copy);
    grad_norm within rel 1e-6, and where the clip scaled a step and the
    norms differ, the params within one bf16 ulp.  The sharded run must
    make every collective of FSDP_COLLECTIVES and launch every kernel of
    FSDP_KERNELS.  Then one `torchrun --nproc_per_node 1 -m
    spacer_tpu_torch.cli.train_sg_rlvr --multihost true --device cuda` step
    at the tiny random-init config.  Returns the sharded run's launches."""
    import torch.distributed as dist

    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    tp.set_mesh(None)    # the unsharded run runs as one process
    world1_env()
    multihost.initialize(device=device)
    backend = "nccl" if device == "cuda" else "gloo"
    if dist.get_backend() != backend or dist.get_world_size() != 1:
        raise RuntimeError(f"expected {backend} at world 1, got "
                           f"{dist.get_backend()} at {dist.get_world_size()}")
    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": 1})
    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=FSDP_LM_LAYERS))
    root = pathlib.Path(__file__).resolve().parent / "build"
    plain = fsdp_train_run(cfg, str(root / "smoke_fsdp_plain"), device=device)
    sharded = fsdp_train_run(cfg, str(root / "smoke_fsdp_sharded"), mesh=mesh,
                             ref=plain, device=device)
    problems = sharded_run_problems(plain, sharded, "fsdp", FSDP_COLLECTIVES,
                                    FSDP_KERNELS)
    counts = sharded["counts"]
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    tp.set_mesh(None)
    cli_step_under_torchrun(root / "smoke_fsdp_cli", device)
    if problems:
        raise RuntimeError("phase 12: " + "; ".join(problems))
    return counts


def cli_step_under_torchrun(root: pathlib.Path, device="cuda"):
    """`torchrun --nproc_per_node 1 chip_smoke.py --cli-step --multihost
    true --device cuda ...`: spacer_tpu_torch.cli.train_sg_rlvr.main for one
    step at the tiny random-init config on one 4-second video row; it must
    exit 0 and record its step.  The tiny config's heads (16 wide) are
    outside every kernel, which raise on CUDA tensors of such shapes, so
    the step runs inside utils.debugging.interpret_kernels (the kernels'
    plain versions on the card; `cli_main`)."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    (video,) = write_videos(root, "clip", 1, 4, 8, seed=5, shift=3)
    with open(root / "train.jsonl", "w") as f:
        f.write(json.dumps({
            "problem": "How many chairs?", "problem_type": "numerical",
            "solution": "<answer>3</answer>", "path": video,
            "data_type": "video", "data_source": "SR_dataset",
            "problem_id": 0}) + "\n")
    with open(root / "cogmap.jsonl", "w") as f:
        f.write(json.dumps({"video_id": "clip0", "cognitive_map": {},
                            "object_list": []}) + "\n")
    out = root / "out"
    seconds = torchrun_self(
        "--cli-step", ["--device", device, "--random_init", "true",
                       "--dataset_name", str(root / "train.jsonl"),
                       "--cognitive_map_path", str(root / "cogmap.jsonl"),
                       "--output_dir", str(out), "--max_steps", "1",
                       "--skip_failed_steps", "false", "--num_generations",
                       "4", "--max_completion_length", "32"],
        out / "metrics.jsonl")
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 1 or recs[0].get("step") != 1:
        raise RuntimeError(f"torchrun train_sg_rlvr recorded {recs}")
    rec = recs[0]
    log(f"fsdp cli: torchrun --nproc_per_node 1 train_sg_rlvr --multihost "
        f"true --device {device}: exit 0 in {seconds:.1f} s, step "
        f"{rec['step']}: "
        f"loss {rec['loss']:.6e} grad_norm {rec['grad_norm']:.6e} reward "
        f"{rec['reward']:.3f}")


def torchrun_self(mode: str, argv: list, result: pathlib.Path) -> float:
    """`torchrun --nproc_per_node 1 chip_smoke.py MODE --multihost true
    ARGV` (cli_main under torchrun's environment for
    rank 0 of 1, its rendezvous on a port torchrun binds itself:
    --standalone), which must exit 0 and write `result`; -> its seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--standalone", __file__, mode, "--multihost", "true", *argv]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT",
                        "TORCHELASTIC_USE_AGENT_STORE")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=str(pathlib.Path(__file__).resolve().parent),
                          env=env)
    if proc.returncode != 0 or not result.exists():
        log(proc.stdout[-3000:])
        log(proc.stderr[-6000:])
        raise RuntimeError(f"torchrun {mode} exited {proc.returncode}")
    return time.perf_counter() - t0


def _world_selected(name: str, kind: str = "qwen") -> bool:
    """The tensors whose gradients --world N compares (FSDP_WORLD_LAYERS,
    FSDP_WORLD_BLOCKS and every tensor outside the layer lists; for Aria,
    EP_WORLD_LAYERS, tower layer 0 and every tensor outside the lists)."""
    parts = name.split("/")
    layers, blocks = ((FSDP_WORLD_LAYERS, FSDP_WORLD_BLOCKS) if kind == "qwen"
                      else (EP_WORLD_LAYERS, (0,)))
    if parts[:2] == ["model", "layers"]:
        return int(parts[2]) in layers
    if parts[:2] in (["visual", "blocks"], ["visual", "encoder"]):
        return int(parts[2]) in blocks
    return True


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device, reset=False) -> int:
    """max_memory_allocated on CUDA (0 elsewhere), optionally reset."""
    if torch.device(device).type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def _world_trainer(out_dir, steps, mesh=None, share_ref=False,
                   device="cuda", kind="qwen"):
    """The --world runs' trainer: Qwen2.5-VL-7B at full depth on
    FSDP_WORLD_ROWS video rows ("qwen"), or ARIA_25B under moe_impl "ep" on
    EP_WORLD_ROWS image rows, its LM cut to EP_WORLD_LM_LAYERS at capacity
    factor EP_WORLD_CF ("aria"; the experts over data: "aria data", over
    data x fsdp: "aria batch") or whole at the default 2.0 ("aria full")."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    if kind != "qwen":
        axis = {"aria data": "data",
                "aria batch": ("data", "fsdp")}.get(kind, "fsdp")
        cfg = (aria_ep_cfg(28) if kind == "aria full"
               else aria_ep_cfg(EP_WORLD_LM_LAYERS, cf=EP_WORLD_CF,
                                ep_axis=axis))
        return aria_ep_trainer(cfg, device, steps, out_dir, mesh=mesh,
                               share_ref=share_ref, rows=EP_WORLD_ROWS,
                               rollout_batch_size=EP_WORLD_ROWS)
    return make_trainer(QWEN25_VL_7B, device, steps, out_dir,
                        videos=(FULL_VIDEOS[0],) * FSDP_WORLD_ROWS,
                        mesh=mesh, share_ref=share_ref,
                        rollout_batch_size=FSDP_WORLD_ROWS)


def _world_reference(rank, out, device="cuda", kind="qwen"):
    """--world N's reference, one process on card 0 without a mesh: step
    1's rollout, loss and the selected gradients (no update: the reference
    model is the policy's own tensors and no moments are kept) -> out/
    ref.pt."""
    trainer, names = _world_trainer(out + "/ref", 1, share_ref=True,
                                    device=device, kind=kind)
    trainer.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    _peak(device, reset=True)
    rec, generate, step_fn = {}, trainer.sampler.generate, trainer.step_fn

    def recorded(*a, **kw):
        _sync(device)
        t = time.perf_counter()
        res = generate(*a, **kw)
        rec.update(rollout=res, rollout_s=time.perf_counter() - t)
        return res

    def loss_only(params, ref_params, opt_state, batch, **kw):
        _sync(device)
        t = time.perf_counter()
        loss, metrics, grads = step_fn.loss_and_grads(
            params, batch["ref_logps"],
            {k: v for k, v in batch.items() if k != "ref_logps"},
            kw["grid_thw"], kw["num_generations"],
            select=lambda n: _world_selected(n, kind))
        _sync(device)
        rec.update(loss=float(loss), grad_s=time.perf_counter() - t,
                   adv_scale=float(batch["advantages"].abs().mean()),
                   grads={n: g.cpu() for n, g in zip(names, grads)
                          if g is not None})
        return params, opt_state, dict(metrics, loss=loss,
                                       grad_norm=torch.zeros(()))

    loss_only.ref_logps_fn = step_fn.ref_logps_fn
    trainer.sampler.generate, trainer.step_fn = recorded, loss_only
    trainer.training_step(trainer.dataset, np.random.default_rng(0))
    rec["peak"] = _peak(device)
    torch.save(rec, out + "/ref.pt")
    log(f"fsdp world reference (1 card, no mesh): rollout "
        f"{rec['rollout_s']:.2f} s, loss and gradients {rec['grad_s']:.2f} s, "
        f"loss {rec['loss']!r}, max_memory_allocated {gib(rec['peak'])}")


def _world_rank(rank, out, device="cuda", shape=None, kind="qwen",
                compare=True):
    """One rank of --world N: fsdp over every rank (or the mesh `shape`,
    tp slices included), the trainer of `kind` (_world_trainer) on this
    rank's share of its rows, two steps; with `compare`, step 1 replays
    the reference's completions (its own rollout still runs and is timed)
    and its gradients are held against the reference's per group."""
    from spacer_tpu_torch.parallel import fsdp, multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh

    world = multihost.process_count()
    mesh = create_mesh(shape) if shape else multihost.global_mesh()
    # at full Aria depth the reference model is the policy's own tensors
    # (its 12.6 GB a rank would not leave room for the tower's backward)
    trainer, names = _world_trainer(f"{out}/rank{rank}", 2, mesh=mesh,
                                    device=device, kind=kind,
                                    share_ref=kind == "aria full")
    ref = (torch.load(out + "/ref.pt", weights_only=False, mmap=True)
           if compare else {"grads": {}})
    raw = fsdp.raw_leaves(trainer.params)
    rec = {"rollout_s": [], "update_s": [], "loss": [], "peak": []}
    generate, step_fn = trainer.sampler.generate, trainer.step_fn
    sums = collections.defaultdict(lambda: torch.zeros(3, dtype=torch.float64,
                                                       device=device))

    def replayed(*a, **kw):
        _sync(device)
        t = time.perf_counter()
        res = generate(*a, **kw)
        rec["rollout_s"].append(time.perf_counter() - t)
        return (ref["rollout"] if compare and len(rec["rollout_s"]) == 1
                else res)

    def sink(update, grads, gnorm):
        if update:
            return
        from spacer_tpu_torch.train.optimizer import BLOCK as B

        for n, g, leaf in zip(names, grads, raw):
            if n not in ref["grads"]:
                continue
            if mesh.coords["data"] and not (isinstance(leaf, fsdp.Shard)
                                            and "data" in leaf.axes):
                continue   # data replicas hold the same blocks
            want = ref["grads"][n]
            if isinstance(leaf, fsdp.Shard):
                if leaf.split is not None:
                    want = leaf.split.take(want)   # this rank's tp slice
                want = want.reshape(-1)
                lo = leaf.block_lo * B
                mine = g.reshape(-1)[:max(0, min(g.numel(), leaf.numel - lo))]
                want = want[lo:lo + mine.numel()]
            elif rank:
                continue   # a replicated gradient counts once
            else:
                want, mine = want.reshape(-1), g.reshape(-1)
            a, b = mine.double(), want.to(mine.device).double()
            sums[_grad_group(n)] += torch.stack([(a * b).sum(), a.square()
                                                 .sum(), b.square().sum()])

    def timed(params, ref_params, opt_state, batch, **kw):
        _sync(device)
        t = time.perf_counter()
        res = step_fn(params, ref_params, opt_state, batch, **kw)
        _sync(device)
        rec["update_s"].append(time.perf_counter() - t)
        rec["loss"].append(float(res[2]["loss"]))
        return res

    timed.ref_logps_fn = step_fn.ref_logps_fn
    GradTap(trainer.tx, sink)
    trainer.sampler.generate, trainer.step_fn = replayed, timed
    rec["apply_s"] = []
    tapped = trainer.tx.apply

    def timed_apply(*a, **kw):
        # the optimizer's update applied (step 1's includes the gradient
        # check above)
        _sync(device)
        t = time.perf_counter()
        res = tapped(*a, **kw)
        _sync(device)
        rec["apply_s"].append(time.perf_counter() - t)
        return res

    trainer.tx.apply = timed_apply
    n_rows = len(trainer.dataset)
    rows = trainer.dataset[rank * n_rows // world:(rank + 1) * n_rows // world]
    multihost.reset_collective_stats()
    multihost.time_collectives(True)
    with DropLog() as drops:
        for step in range(2):
            _peak(device, reset=True)
            trainer.training_step(rows, np.random.default_rng(step))
            rec["peak"].append(_peak(device))
    rec["collectives"] = multihost.collective_stats()
    rec["drops"] = drops.counts()
    # replicated tensors' groups are summed on rank 0 only, the shards' and
    # tp slices' on every rank of data index 0
    groups = sorted(set().union(*multihost.all_gather_objects(sorted(sums))))
    rec["cos"] = {}
    if groups:
        vec = torch.stack([sums[g] for g in groups])
        multihost.all_reduce(vec, None)
        # two zero gradients (a step whose advantages all vanish) agree
        rec["cos"] = {g: (float(d / math.sqrt(x * y)) if x * y > 0
                          else float(x == y)) for g, (d, x, y)
                      in zip(groups, vec.tolist())}
    if compare:
        rec["ref_loss"], rec["adv_scale"] = ref["loss"], ref["adv_scale"]
        rec["ref_rollout_s"] = ref["rollout_s"]
        rec["ref_grad_s"], rec["ref_peak"] = ref["grad_s"], ref["peak"]
    parts = multihost.all_gather_objects(rec)
    if rank == 0:
        torch.save(parts, out + "/world.pt")


def fsdp_world_phase(world: int, device="cuda"):
    """`--phases 12 --world N`: the reference on card 0, then N ranks
    (parallel.multihost.launch_local, NCCL, fsdp N) at full depth; the gate
    and the numbers of each rank (FSDP_WORLD_* above)."""
    out = str(pathlib.Path(__file__).resolve().parent / "build"
              / "smoke_fsdp_world")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("fsdp world cards (nvidia-smi): "
        + " | ".join(smi.stdout.strip().splitlines()[:world]))
    from spacer_tpu_torch.parallel.multihost import launch_local

    # every process hashes the mock tokenizer's words alike
    os.environ["PYTHONHASHSEED"] = "0"
    launch_local(_world_reference, 1, args=(out, device), device=device,
                 timeout=1200)
    launch_local(_world_rank, world, args=(out, device), device=device,
                 timeout=1800)
    report_world_ranks(out, world, "fsdp")


def report_world_ranks(out, world: int, name: str):
    """Log the ranks' records of a --world run (_world_rank -> world.pt)
    and raise RuntimeError unless the step-1 loss is within
    FSDP_WORLD_LOSS_RTOL of the reference's (scaled as below) and every
    group's gradient cosine is >= FSDP_WORLD_COS_TOL."""
    parts = torch.load(out + "/world.pt", weights_only=False)
    first = parts[0]
    for r, p in enumerate(parts):
        log(f"{name} world {world} rank {r}: rollout s per step "
            f"{[round(x, 2) for x in p['rollout_s']]}, update s per step "
            f"{[round(x, 2) for x in p['update_s']]}, peak per step "
            f"{[gib(x) for x in p['peak']]}, loss {p['loss']}")
        log(f"{name} world {world} rank {r}: collectives per step: "
            + _collective_line(p["collectives"], 2))
    cos = first["cos"]
    dl = abs(first["loss"][0] - first["ref_loss"])
    log(f"{name} world {world} vs world 1 at step 1: loss {first['loss'][0]!r} "
        f"vs {first['ref_loss']!r} (|diff| {dl:.3e}, mean |advantage| "
        f"{first['adv_scale']:.4f}); gradient cosine per group: "
        + ", ".join(f"{g} {c:.6f}" for g, c in sorted(cos.items())))
    log(f"{name} world 1 reference: rollout {first['ref_rollout_s']:.2f} s, "
        f"loss and gradients {first['ref_grad_s']:.2f} s, max_memory_"
        f"allocated {gib(first['ref_peak'])}")
    # the step-1 loss is a mean of per-row terms of +-|advantage| that
    # cancel (advantages are centred per group): its scale is the mean
    # |advantage|, not its own value near zero
    scale = max(abs(first["ref_loss"]), first["adv_scale"])
    if dl > FSDP_WORLD_LOSS_RTOL * scale:
        raise RuntimeError(f"world {world} step-1 loss {first['loss'][0]} vs "
                           f"{first['ref_loss']}")
    if not min(cos.values()) >= FSDP_WORLD_COS_TOL:
        raise RuntimeError(f"gradient cosine below {FSDP_WORLD_COS_TOL}: "
                           f"{cos}")


SERVE_KERNELS = ("K1", "K3", "K4", "K5")
SERVE_INT4_KV_KERNELS = ("K1", "K3", "K4", "K5-int8", "K6")
TRAIN_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K2-int8", "K3", "K4")
ROLLOUT_BF16_KERNELS = ("K1", "K2", "K3", "K4")
EVAL_STATIC_KERNELS = ("K1", "K2", "K3", "K4")
EVAL_CONTINUOUS_KERNELS = ("K1", "K3", "K4", "K5")
FULL_TRAIN_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K2-int8", "K3", "K4")
LORA_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K3", "K4")
SFT_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K3", "K4")
HTTP_KERNELS = ("K1", "K3", "K4", "K5")
# the speculative paths decode through the block attention (torch ops),
# not K5 / K2; under int4_kv their weight products are K6 at M = R * kb
SPEC_SERVE_KERNELS = ("K1", "K3", "K4")
SPEC_SERVE_INT4_KV_KERNELS = ("K1", "K3", "K4", "K6")
SPEC_ROLLOUT_KERNELS = ("K1", "K3", "K4")
QWEN2_KERNELS = ("K1", "K4", "K5")
ARIA_SERVE_KERNELS = ("K1", "K5")
ARIA_SERVE_INT4_KV_KERNELS = ("K1", "K5-int8", "K6")
ARIA_TRAIN_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv", "K2-int8")

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
    # the head_dim instantiations counted apart (ops.HEAD_DIM_IDS; their
    # launches are also in K1's / K1-bwd's)
    "K1 d80": ("flash_attention (head_dim 80)",
               "spacer_tpu_torch/csrc/flash_attention.cu",
               "spacer_tpu/ops/flash_attention.py:298"),
    "K1-bwd dq d80": ("flash_attention_bwd_dq (head_dim 80)",
                      "spacer_tpu_torch/csrc/flash_attention_bwd.cu",
                      "spacer_tpu/ops/flash_attention.py:368"),
    "K1-bwd dkv d80": ("flash_attention_bwd_dkv (head_dim 80)",
                       "spacer_tpu_torch/csrc/flash_attention_bwd.cu",
                       "spacer_tpu/ops/flash_attention.py:413"),
    "K1-bwd dq d72": ("flash_attention_bwd_dq (head_dim 72)",
                      "spacer_tpu_torch/csrc/flash_attention_bwd.cu",
                      "spacer_tpu/ops/flash_attention.py:368"),
    "K1-bwd dkv d72": ("flash_attention_bwd_dkv (head_dim 72)",
                       "spacer_tpu_torch/csrc/flash_attention_bwd.cu",
                       "spacer_tpu/ops/flash_attention.py:413"),
}


class SampleTap:
    """Records every sampled step's logits and tokens of the grouped
    sampler (sampler.sample_logits: the static path's prefill and decode
    steps); with `replay` (an earlier run's tokens) the sampler returns
    those instead, so a second run sees identical inputs."""

    def __init__(self, replay=None):
        self.replay, self.logits, self.tokens = replay, [], []

    def __enter__(self):
        import spacer_tpu_torch.sampler.sampler as sm

        self.sm, self.saved = sm, sm.sample_logits

        def recorded(logits, *a, **kw):
            tokens = self.saved(logits, *a, **kw)
            if self.replay is not None:
                tokens = self.replay[len(self.tokens)]
            self.logits.append(logits.float())
            self.tokens.append(tokens)
            return tokens

        sm.sample_logits = recorded
        return self

    def __exit__(self, *exc):
        self.sm.sample_logits = self.saved
        return False


def tp_serve_runs(cfg, params, proc, msgs, replay=None) -> dict:
    """Phase 13's serving on `params` (sharded or not): phase 4's requests
    through generate_many at bf16 ("serve") and int4_kv ("serve int4_kv"),
    then one static QwenEngine.generate of them (bf16, "static"); with
    `replay` (an earlier call's result) each run returns those tokens.
    -> {run: texts, tokens and logits per sampled step (host), launches,
    decode ms per step, peak, wall s, tp collectives}."""
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel import multihost

    dev = params["model"]["embed_tokens"]["embedding"].device
    runs = {}
    for run, quant in (("serve", None), ("serve int4_kv", "int4_kv"),
                       ("static", None)):
        engine = QwenEngine(cfg, params, proc, decode_quant=quant)
        rep = (None if replay is None
               else [t.to(dev) for t in replay[run]["tokens"]])
        probe = (SampleTap(rep) if run == "static"
                 else SliceProbe(replay=rep))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        multihost.reset_collective_stats()
        with probe:
            t0 = time.perf_counter()
            if run == "static":
                texts = engine.generate(
                    msgs, max_new_tokens=SERVE_GEN_KW["max_new_tokens"],
                    temperature=0.0)
            else:
                texts = engine.generate_many(msgs, **SERVE_GEN_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[run] = dict(
            texts=texts, tokens=[t.cpu() for t in probe.tokens],
            logits=[x.cpu() for x in probe.logits], counts=launch_counts(),
            decode_ms=list(getattr(probe, "decode_ms", [])),
            peak=torch.cuda.max_memory_allocated(), wall=wall,
            tp={k: v["calls"] for k, v in multihost.collective_stats().items()
                if k.startswith("tp_")})
        del engine, probe
    return runs


def tp_phase(device="cuda") -> dict:
    """Phase 13: the tensor-parallel code paths at world 1 over NCCL
    (parallel.multihost.initialize() from torchrun's environment for rank 0
    of 1; create_mesh({"data": 1, "fsdp": 1, "tp": 1}): every tp collective
    counted, none issued), Qwen2.5-VL-7B widths with the LM cut to
    TP_LM_LAYERS layers.  Each once unsharded and once over the mesh
    (shard_params with the Qwen tp plan, the fsdp shards gathered once as
    the serve CLI does): phase 4's requests through generate_many, bf16
    and int4_kv, and one static generate (tp_serve_runs); then two
    SG-RLVR steps (TP_TRAIN_G completions of up to TP_TRAIN_NEW_TOKENS on a
    TP_TRAIN_VIDEO row).  Gates: tokens and the logits of every sampled
    step bitwise equal, the training runs under phase 12's gate
    (sharded_run_problems), the tp collectives counted, every kernel of
    each path launched.  Then a torchrun launch of cli/serve.py
    (--multihost true --tp 1) on a jsonl file at the tiny config
    (cli_serve_under_torchrun).  Returns the launches of the sharded paths,
    {path: {kernel id: count}}."""
    import torch.distributed as dist

    from spacer_tpu_torch.cli.common import serving_params
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        qwen_tp_plan,
        shard_params,
    )

    tp.set_mesh(None)
    world1_env()
    multihost.initialize(device=device)
    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": 1})
    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=TP_LM_LAYERS))
    problems, paths = [], {}
    params, proc, msgs = serving_setup(cfg, device)
    plain = tp_serve_runs(cfg, params, proc, msgs)
    sp = serving_params(shard_params(params, mesh, QWEN_PARTITION_RULES,
                                     qwen_tp_plan(cfg))[0], mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    sharded = tp_serve_runs(cfg, sp, proc, msgs)
    del sp
    kernels = {"serve": SERVE_KERNELS, "serve int4_kv": SERVE_INT4_KV_KERNELS,
               "static": EVAL_STATIC_KERNELS}
    for run, a in plain.items():
        b = sharded[run]
        same_tokens = (len(a["tokens"]) == len(b["tokens"]) and all(
            torch.equal(x, y) for x, y in zip(a["tokens"], b["tokens"])))
        same_logits = (len(a["logits"]) == len(b["logits"]) and all(
            torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])))
        diff = max((float((x - y).abs().max()) for x, y in
                    zip(a["logits"], b["logits"]) if x.shape == y.shape),
                   default=float("nan"))
        per_step = {k: v / max(1, len(b["tokens"])) for k, v in b["tp"].items()}
        ms = (f"{statistics.median(b['decode_ms']):.2f} vs "
              f"{statistics.median(a['decode_ms']):.2f}"
              if a["decode_ms"] and b["decode_ms"] else "not measured")
        log(f"tp world 1 [{run}]: tokens equal {same_tokens}, logits bitwise "
            f"{same_logits} over {len(b['logits'])} sampled steps (max |diff| "
            f"{diff:.3e}) | decode ms per step median, tp paths vs none: {ms} "
            f"| wall {b['wall']:.2f} vs {a['wall']:.2f} s | peak "
            f"{gib(b['peak'])} vs {gib(a['peak'])} | tp collectives "
            f"{b['tp']} ({ {k: round(v, 1) for k, v in per_step.items()} } "
            f"per sampled step) | launches {b['counts']}")
        if not (same_tokens and same_logits):
            problems.append(f"{run}: tokens or logits differ")
        if not all(b["tp"].get(k) for k in ("tp_all_reduce", "tp_all_gather")):
            problems.append(f"{run}: tp collectives not counted: {b['tp']}")
        if min(b["counts"][k] for k in kernels[run]) < 1:
            problems.append(f"{run}: a kernel of the path was never launched")
        paths[f"tp world 1 {run}"] = b["counts"]
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()

    root = pathlib.Path(__file__).resolve().parent / "build"
    kw = dict(videos=(TP_TRAIN_VIDEO,), num_generations=TP_TRAIN_G,
              max_completion_length=TP_TRAIN_NEW_TOKENS)
    tp.set_mesh(None)
    plain = fsdp_train_run(cfg, str(root / "smoke_tp_plain"), device=device,
                           **kw)
    shard = fsdp_train_run(cfg, str(root / "smoke_tp_sharded"), mesh=mesh,
                           ref=plain, device=device, **kw)
    problems += sharded_run_problems(plain, shard, "tp", TP_COLLECTIVES,
                                     FSDP_KERNELS)
    log("tp train: tp collectives per step: " + _collective_line(
        {k: v for k, v in shard["collectives"].items()
         if k.startswith("tp_")}, 2))
    paths["tp world 1 train"] = shard["counts"]
    del plain, shard
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    tp.set_mesh(None)
    cli_serve_under_torchrun(root / "smoke_tp_cli", device)
    if problems:
        raise RuntimeError("phase 13: " + "; ".join(problems))
    return paths


def cli_serve_under_torchrun(root: pathlib.Path, device="cuda"):
    """`torchrun --nproc_per_node 1 chip_smoke.py --cli-serve --multihost
    true --tp 1 --device cuda ...`: spacer_tpu_torch.cli.serve.main on a
    jsonl file of 3 text prompts at the tiny random-init config, inside
    utils.debugging.interpret_kernels (the tiny heads are outside every
    kernel; cli_step_under_torchrun says why); it must exit 0 and write a
    completion per row."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rows = [{"prompt": "how many chairs are there"}, {"prompt": "what now"},
            {"messages": [{"role": "user", "content": "hello"}]}]
    with open(root / "in.jsonl", "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    out = root / "out.jsonl"
    seconds = torchrun_self(
        "--cli-serve", ["--tp", "1", "--device", device, "--random_init",
                        "true", "--input_file", str(root / "in.jsonl"),
                        "--output_file", str(out), "--max_new_tokens", "8",
                        "--temperature", "0"], out)
    with open(out) as f:
        done = [json.loads(line) for line in f]
    if len(done) != len(rows) or not all("completion" in d for d in done):
        raise RuntimeError(f"torchrun cli.serve wrote {done}")
    log(f"tp cli: torchrun --nproc_per_node 1 serve --multihost true --tp 1 "
        f"--device {device}: exit 0 in {seconds:.1f} s, {len(done)} "
        f"completions")


def _tp_eval(params, cfg, out_dir, device="cuda") -> dict:
    """Phase 7's LongVideoBench rows through run_benchmark (static, as
    cli/evaluate.py runs by default) on `params`: {"answers": {id:
    predicted answer}, "metrics", "errors", "s"}; under a process group
    rank 0 writes, the others return no metrics."""
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.evalharness import EvalConfig, QwenEngine, run_benchmark
    from spacer_tpu_torch.evalharness.util import read_jsonl

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data_file, video_dir = write_eval_data(out_dir)
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg,
                       device=device)
    engine = RecordingEngine(QwenEngine(cfg, params, proc))
    ecfg = EvalConfig(task="LongVideoBench", data_file=data_file,
                      video_dir=video_dir, output_dir=str(out_dir / "out"),
                      num_frames=32, fps=1, prompt_type="thinking",
                      max_new_tokens=EVAL_NEW_TOKENS, temperature=0.0,
                      batch_size=2, serving="static")
    t0 = time.perf_counter()
    metrics = run_benchmark(ecfg, engine)
    torch.cuda.synchronize()
    res = {"metrics": metrics, "errors": [repr(e) for e in engine.errors],
           "s": time.perf_counter() - t0, "answers": {}}
    results = out_dir / "out" / "LongVideoBench_results.jsonl"
    if results.exists():
        res["answers"] = {d["id"]: d["predicted_answer"]
                          for d in read_jsonl(str(results))}
    return res


def _tp_world_reference(rank, out, device="cuda"):
    """--phases 13 --world's reference, one process on card 0 without a
    mesh at full Qwen2.5-VL-7B depth: tp_serve_runs (tokens and logits of
    every sampled step) and the eval's answers -> out/serve_ref.pt, then
    phase 12's GRPO reference (_world_reference -> out/ref.pt)."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    params, proc, msgs = serving_setup(QWEN25_VL_7B, device)
    runs = tp_serve_runs(QWEN25_VL_7B, params, proc, msgs)
    runs["eval"] = _tp_eval(params, QWEN25_VL_7B, out + "/eval_ref", device)
    torch.save(runs, out + "/serve_ref.pt")
    for run, r in runs.items():
        if run != "eval":
            log(f"tp world reference [{run}] (1 card): decode ms per step "
                + (f"{statistics.median(r['decode_ms']):.2f}"
                   if r["decode_ms"] else "not measured")
                + f", wall {r['wall']:.2f} s, max_memory_allocated "
                  f"{gib(r['peak'])}")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    _world_reference(rank, out, device)


def _tp_world_serve(rank, out, device="cuda"):
    """One rank of --phases 13 --world N's serving: the full-depth model
    split over tp = N (shard_params with the Qwen tp plan, the fsdp shards
    gathered once), the reference's runs replayed (its tokens) with every
    sampled step's logits held against its by cosine, then the eval's rows
    -> out/serve_world.pt (rank 0)."""
    from spacer_tpu_torch.cli.common import serving_params
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        qwen_tp_plan,
        shard_params,
    )

    world = multihost.process_count()
    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": world})
    ref = torch.load(out + "/serve_ref.pt", weights_only=False)
    params, proc, msgs = serving_setup(QWEN25_VL_7B, device)
    params = serving_params(shard_params(params, mesh, QWEN_PARTITION_RULES,
                                         qwen_tp_plan(QWEN25_VL_7B))[0], mesh)
    gc.collect()
    torch.cuda.empty_cache()
    runs = tp_serve_runs(QWEN25_VL_7B, params, proc, msgs, replay=ref)
    rec = {}
    for run, r in runs.items():
        cos = [float(torch.nn.functional.cosine_similarity(
            a, b, dim=-1).min()) for a, b in zip(r["logits"],
                                                 ref[run]["logits"])]
        rec[run] = {k: r[k] for k in ("decode_ms", "peak", "wall", "tp",
                                      "counts")}
        rec[run].update(cos_min=min(cos), cos_median=statistics.median(cos),
                        steps=len(cos), ref_steps=len(ref[run]["logits"]))
    rec["eval"] = _tp_eval(params, QWEN25_VL_7B, f"{out}/eval_{world}",
                           device)
    parts = multihost.all_gather_objects(rec)
    if rank == 0:
        torch.save(parts, out + "/serve_world.pt")


def tp_world_phase(worlds, device="cuda"):
    """`--phases 13 --world N[,M]`: the reference on card 0
    (_tp_world_reference), then for each N: N ranks serving and evaluating
    the model split over tp = N (_tp_world_serve: logits cosine >=
    SLICE_COS_TOL at every sampled step with the reference's tokens
    replayed), and a GRPO step at (data 1, fsdp 1, tp N) and, at N = 4, at
    (1, 2, 2) (phase 12's _world_rank: the step-1 loss and per-group
    gradient cosines under FSDP_WORLD_LOSS_RTOL / FSDP_WORLD_COS_TOL);
    per-rank peaks, ms per decode step, s per step and tp collectives per
    step are logged."""
    out = str(pathlib.Path(__file__).resolve().parent / "build"
              / "smoke_tp_world")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("tp world cards (nvidia-smi): "
        + " | ".join(smi.stdout.strip().splitlines()[:max(worlds)]))
    from spacer_tpu_torch.parallel.multihost import launch_local

    os.environ["PYTHONHASHSEED"] = "0"
    launch_local(_tp_world_reference, 1, args=(out, device), device=device,
                 timeout=1800)
    ref = torch.load(out + "/serve_ref.pt", weights_only=False)
    problems = []
    for world in worlds:
        launch_local(_tp_world_serve, world, args=(out, device),
                     device=device, timeout=1800)
        parts = torch.load(out + "/serve_world.pt", weights_only=False)
        for r, part in enumerate(parts):
            for run in ("serve", "serve int4_kv", "static"):
                p, a = part[run], ref[run]
                ms = (f"{statistics.median(p['decode_ms']):.2f} vs "
                      f"{statistics.median(a['decode_ms']):.2f}"
                      if p["decode_ms"] else "not measured")
                steps = max(1, p["steps"])
                log(f"tp={world} rank {r} [{run}]: logits cosine min "
                    f"{p['cos_min']:.5f} median {p['cos_median']:.5f} over "
                    f"{p['steps']} sampled steps (reference {p['ref_steps']}; "
                    f"tol {SLICE_COS_TOL}) | decode ms per step median vs 1 "
                    f"card: {ms} | wall {p['wall']:.2f} vs {a['wall']:.2f} s "
                    f"| max_memory_allocated {gib(p['peak'])} vs "
                    f"{gib(a['peak'])} | tp collectives per sampled step "
                    + str({k: round(v / steps, 1) for k, v in p["tp"].items()}))
                if not (p["steps"] == p["ref_steps"]
                        and p["cos_min"] >= SLICE_COS_TOL):
                    problems.append(f"tp={world} {run} rank {r}: cosine "
                                    f"{p['cos_min']} over {p['steps']} steps")
        ev, ev_ref = parts[0]["eval"], ref["eval"]
        agree = sum(ev["answers"].get(i) == x
                    for i, x in ev_ref["answers"].items())
        log(f"tp={world} eval (LongVideoBench, static): {len(ev['answers'])} "
            f"rows, {agree} of {len(ev_ref['answers'])} answers as the 1-card "
            f"run's, metrics {ev['metrics']}, {ev['s']:.1f} s vs "
            f"{ev_ref['s']:.1f} s, engine errors {ev['errors']}")
        if ev["errors"] or len(ev["answers"]) != len(ev_ref["answers"]):
            problems.append(f"tp={world} eval: {ev['errors']}")
        shapes = [{"data": 1, "fsdp": 1, "tp": world}]
        if world == 4:
            shapes.append({"data": 1, "fsdp": 2, "tp": 2})
        for shape in shapes:
            launch_local(_world_rank, world, args=(out, device, shape),
                         device=device, timeout=1800)
            try:
                report_world_ranks(out, world, f"tp {shape}")
            except RuntimeError as e:
                problems.append(str(e))
    if problems:
        raise RuntimeError("phase 13 --world: " + "; ".join(problems))


# Phase 14: expert parallelism (spacer_tpu_torch/parallel/expert.py) and
# Aria's tensor parallelism at world 1 over NCCL: ARIA_25B widths with the
# LM cut to ARIA_EP_LM_LAYERS of 28 layers, moe_impl "ep" at its default
# capacity factor 2.0; the training run takes ARIA_EP_TRAIN_G completions
# of up to ARIA_EP_TRAIN_NEW_TOKENS on phase 11's image.
ARIA_EP_LM_LAYERS = 4
ARIA_EP_TRAIN_G, ARIA_EP_TRAIN_NEW_TOKENS = 4, 64
# the collectives the world-1 mesh runs must count (the ep and tp ones are
# counted and not issued at world 1)
EP_SERVE_COLLECTIVES = ("ep_all_gather", "ep_reduce_scatter",
                        "tp_all_reduce", "tp_all_gather")
EP_TRAIN_COLLECTIVES = EP_SERVE_COLLECTIVES + ("all_gather", "reduce_scatter",
                                               "all_reduce")
# --phases 14 --world N[,M] (a development run on a host with that many
# cards): serving at full depth over tp N against the 1-card run, every
# sampled step's logits at cosine >= EP_WORLD_COS_TOL; GRPO steps on
# EP_WORLD_ROWS image rows: with the LM cut to EP_WORLD_LM_LAYERS at
# capacity factor EP_WORLD_CF (nothing drops) against world 1 (step-1
# gradients of LM layers EP_WORLD_LAYERS, tower layer 0 and every tensor
# outside the lists, per group at cosine >= FSDP_WORLD_COS_TOL), and at
# full depth over (data 1, fsdp 4, tp 1) with its numbers only (its
# reference model the policy's own tensors).
EP_WORLD_COS_TOL = 0.999
EP_WORLD_ROWS = 4
EP_WORLD_LM_LAYERS = 4
# C >= T at a capacity factor >= E / K (64 / 6): no assignment can drop
# (at 8.0, 4.3 % of this step's assignments dropped on four H100s: the
# pads and the image's projector tokens route alike)
EP_WORLD_CF = 11.0
EP_WORLD_LAYERS = (0,)


def aria_ep_cfg(layers: int = ARIA_EP_LM_LAYERS, impl: str = "ep",
                cf: float | None = None, ep_axis="fsdp"):
    """ARIA_25B with its LM cut to `layers`, moe_impl `impl` over
    `ep_axis` (and a capacity factor `cf`, else the config's 2.0)."""
    from spacer_tpu_torch.models.aria import ARIA_25B

    text = dataclasses.replace(ARIA_25B.text, num_layers=layers, moe_impl=impl,
                               moe_ep_axis=ep_axis)
    if cf is not None:
        text = dataclasses.replace(text, moe_capacity_factor=cf)
    return dataclasses.replace(ARIA_25B, text=text)


class DropLog:
    """Counts the MoE's kept and dropped assignments (ops/moe
    kept_expert_ffn's `keep`: under "ep" with rows split, an owner sees its
    ep group's assignments), summed on the device and read once; with
    `record`, keeps each call's keep mask too (`keeps`)."""

    def __init__(self, record: bool = False):
        self.record, self.keeps = record, []

    def __enter__(self):
        import spacer_tpu_torch.ops.moe as moe

        self.moe, self.saved = moe, moe.kept_expert_ffn
        self.dropped, self.total, self.calls = 0, 0, 0

        def counted(fc1, fc2, xt, code, keep, *a):
            self.dropped = self.dropped + (~keep).sum()
            self.total += keep.numel()
            self.calls += 1
            if self.record:
                self.keeps.append(keep.detach().clone())
            return self.saved(fc1, fc2, xt, code, keep, *a)

        moe.kept_expert_ffn = counted
        return self

    def __exit__(self, *exc):
        self.moe.kept_expert_ffn = self.saved
        return False

    def counts(self) -> dict:
        return {"dropped": int(self.dropped), "assignments": self.total,
                "calls": self.calls}


class ForcedDrops:
    """The dropless MoE ("ragged") with an ep run's dropped assignments
    forced: ops/moe.combine, which both impls call once per MoE call,
    weights a dropped assignment's output by 0 (`keeps`: that run's keep
    masks in call order)."""

    def __init__(self, keeps):
        self.keeps, self.n = keeps, 0

    def __enter__(self):
        import spacer_tpu_torch.ops.moe as moe

        self.moe, self.saved = moe, moe.combine

        def forced(y, scores):
            keep = self.keeps[self.n].to(y.device)
            self.n += 1
            return self.saved(y * keep[:, None].to(y.dtype), scores)

        moe.combine = forced
        return self

    def __exit__(self, *exc):
        self.moe.combine = self.saved
        return False


def keep_rule_problems(routes, keeps, cfg) -> int:
    """The calls whose kept assignments are not JAX's rule on their own
    routes: an assignment is kept iff its position in its expert, counted
    in flat (token, k) order (the one-hot cumsum of spacer_tpu's
    moe_mlp_ep), is below C = moe_capacity(T, K, E, capacity factor)."""
    from spacer_tpu_torch.ops.moe import moe_capacity

    t, bad = cfg.text, 0
    for idx, keep in zip(routes, keeps):
        idx = idx.to(keep.device)
        T, K = idx.shape
        flat = idx.reshape(-1)
        oh = torch.nn.functional.one_hot(flat, t.moe_num_experts)
        pos = (oh.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
        C = moe_capacity(T, K, t.moe_num_experts, t.moe_capacity_factor)
        bad += int(not torch.equal(pos < C, keep))
    return bad + abs(len(routes) - len(keeps))


def cosine_line(a_steps, b_steps) -> str:
    cos = torch.stack([torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
                       for a, b in zip(a_steps, b_steps)])
    return (f"logits cosine min {float(cos.min()):.5f} median "
            f"{float(cos.median()):.5f} over {len(cos)} sampled steps")


class IssuedCollectives:
    """Counts the torch.distributed collectives actually issued (the
    counted-but-not-issued ones of a group of one never reach them)."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "broadcast", "all_gather_object",
             "broadcast_object_list", "batch_isend_irecv")

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.saved, self.calls = dist, {}, collections.Counter()
        for name in self.NAMES:
            fn = self.saved[name] = getattr(dist, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)
        return False


def aria_ep_trainer(cfg, device, steps: int, out_dir: str, mesh=None,
                    share_ref=False, rows: int = 1, **overrides):
    """make_trainer's Aria counterpart: random bf16 weights from seed 0
    at `cfg`, `rows` rows of phase 11's image, ARIA_EP_TRAIN_G completions
    of up to ARIA_EP_TRAIN_NEW_TOKENS, int8_kv rollouts, beta 0.04, int8
    moments; with a `mesh` the params are sharded onto it by
    ARIA_PARTITION_RULES and Aria's tp plan (the experts placed by expert
    under moe_impl "ep"), the full tensors freed before the trainer copies
    its reference.  -> (trainer, the params' paths)."""
    from spacer_tpu_torch.models.aria import init_params
    from spacer_tpu_torch.models.registry import get_family
    from spacer_tpu_torch.parallel.partition import (
        ARIA_PARTITION_RULES,
        aria_tp_plan,
        shard_params,
    )
    from spacer_tpu_torch.rewards import accuracy_reward, format_reward
    from spacer_tpu_torch.train.step import param_leaves
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    names = [n for n, _ in param_leaves(params)]
    log(f"aria ep train init: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f}"
        f" B params bf16, LM {cfg.text.num_layers} layers, moe_impl "
        f"{cfg.text.moe_impl} cf {cfg.text.moe_capacity_factor}, in "
        f"{time.perf_counter() - t0:.1f} s")
    if mesh is not None:
        params = shard_params(params, mesh, ARIA_PARTITION_RULES,
                              aria_tp_plan(cfg))[0]
        gc.collect()
        torch.cuda.empty_cache()
    family = get_family("aria")
    root = pathlib.Path(__file__).resolve().parent / "build" / "smoke_aria"
    image = aria_image(root)
    data = [{"problem": f"How many chairs are in the room? ({i})",
             "problem_type": "numerical", "solution": "<answer>3</answer>",
             "path": image, "data_type": "image", "data_source": "synthetic",
             "problem_id": i,
             "prompt": [{"role": "user", "content": [
                 {"type": "image"},
                 {"type": "text", "text": "How many chairs are in the room?"}]}]}
            for i in range(rows)]
    shutil.rmtree(out_dir, ignore_errors=True)
    args = SGRLVRConfig(
        num_generations=ARIA_EP_TRAIN_G,
        max_completion_length=ARIA_EP_TRAIN_NEW_TOKENS, temperature=1.0,
        top_p=0.95, beta=0.04, moment_dtype="int8", max_steps=steps,
        num_train_epochs=steps, logging_steps=1, save_steps=10 ** 9,
        skip_failed_steps=False, output_dir=out_dir, seed=0)
    args = dataclasses.replace(args, **overrides)
    trainer = SGRLVRTrainer(
        cfg, params, family.make_processor(
            family.mock_tokenizer(cfg.text.vocab_size), cfg),
        [synthetic_reward, accuracy_reward, format_reward], data, args,
        mesh=mesh, ref_params=params if share_ref else None)
    return trainer, names


def aria_ep_requests(cfg, proc):
    """Phase 11's four text conversations and its image request (the
    Sampler.generate inputs of one ARIA_IMAGE_HW image)."""
    from spacer_tpu_torch.models.registry import aria_positions, get_family

    rng = np.random.default_rng(11)
    words = [f"word{i}" for i in range(5000)]
    msgs = [[{"role": "user", "content": " ".join(rng.choice(words, nw))}]
            for nw in (200, 150, 190, 120)]
    root = pathlib.Path(__file__).resolve().parent / "build" / "smoke_aria"
    enc = proc.process_messages([[{"role": "user", "content": [
        {"type": "image", "image": aria_image(root)},
        {"type": "text", "text": "how many chairs are in the room"}]}]])
    vk, _ = get_family("aria").pack_vision(enc)
    pos, deltas = aria_positions(cfg, enc["input_ids"], enc["attention_mask"])
    image = ((enc["input_ids"], enc["attention_mask"]),
             dict(position_ids=pos, deltas=deltas, vision_kwargs=vk,
                  num_generations=1, max_new_tokens=ARIA_NEW_TOKENS,
                  temperature=0.0))
    return msgs, image


def aria_ep_serve_runs(cfg, params, proc, msgs, image, replay=None,
                       static=False, force_drops=False) -> dict:
    """Aria's serving on `params` (sharded or not): the text requests
    through generate_many at bf16 ("serve") and int4_kv ("serve
    int4_kv"), the image through Sampler.generate ("image") and, with
    `static`, one static QwenEngine.generate of the texts ("static");
    with `replay` (an earlier call's result) each run takes its tokens and
    MoE routes, and with `force_drops` its dropped assignments
    (ForcedDrops).  -> {run: tokens and logits per sampled step, routes
    and keep masks (host), launches, decode ms per step, peak, wall, ep /
    tp collectives counted, the torch.distributed calls issued, drops}."""
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.sampler import Sampler

    dev = params["model"]["embed_tokens"]["embedding"].device
    kw = dict(max_new_tokens=ARIA_NEW_TOKENS, temperature=0.0, slots=4)
    runs = {}
    names = [("serve", None), ("serve int4_kv", "int4_kv"), ("image", None)]
    for run, quant in names + ([("static", None)] if static else []):
        rep = routes = None
        if replay is not None:
            rep = [t.to(dev) for t in replay[run]["tokens"]]
            routes = [t.to(dev) for t in replay[run]["routes"]]
        probe = (SampleTap(rep) if run == "static" else SampleLog(rep)
                 if run == "image" else SliceProbe(replay=rep))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        multihost.reset_collective_stats()
        forced = (ForcedDrops(replay[run]["keeps"]) if force_drops
                  else contextlib.nullcontext())
        with probe, RouteLog(replay=routes) as rl, DropLog(True) as drops, \
                forced, IssuedCollectives() as issued:
            t0 = time.perf_counter()
            if run == "image":
                Sampler(cfg, eos_token_id=proc.eos_token_id,
                        pad_token_id=proc.pad_token_id).generate(
                    *image[0], params, **image[1])
            elif run == "static":
                QwenEngine(cfg, params, proc).generate(
                    msgs, max_new_tokens=ARIA_NEW_TOKENS, temperature=0.0)
            else:
                QwenEngine(cfg, params, proc, decode_quant=quant
                           ).generate_many(msgs, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[run] = dict(
            tokens=[t.cpu() for t in probe.tokens],
            logits=[x.cpu() for x in probe.logits],
            routes=[t.cpu() for t in rl.idx], flips=rl.flips,
            keeps=[k.cpu() for k in drops.keeps],
            counts=launch_counts(),
            decode_ms=list(getattr(probe, "decode_ms", [])),
            peak=torch.cuda.max_memory_allocated(), wall=wall,
            collectives={k: v["calls"] for k, v in
                         multihost.collective_stats().items()
                         if k.startswith(("ep_", "tp_"))},
            issued=dict(issued.calls), drops=drops.counts())
        del probe
    return runs


def aria_moe_ms(params, cfg, M: int = 4) -> tuple:
    """One MoE layer (layer 0's moe_mlp under cfg's impl) on M decode
    tokens, as the serving decode calls it (under the active mesh's tp,
    every rank the same rows) -> (CUDA-event ms per call, median of
    TIMED_RUNS: under tp the ranks run in lockstep through its all-reduce;
    device ms from torch.profiler, which under tp also counts the NCCL
    kernel's wait for the other ranks' hosts)."""
    from spacer_tpu_torch.ops import moe
    from spacer_tpu_torch.parallel import expert

    from spacer_tpu_torch.parallel.fsdp import gather_params

    t = cfg.text
    mlp = gather_params(params["model"]["layers"][0]["mlp"])
    dev = mlp["router"]["kernel"].device
    x = torch.randn((M, 1, t.hidden_size), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev).to(mlp["router"]["kernel"].dtype)
    I = t.intermediate_size

    def call():
        with torch.no_grad(), expert.rows(expert.EVERY_RANK):
            return moe.moe_mlp(mlp, x, topk=t.moe_topk, impl=t.moe_impl,
                               capacity_factor=t.moe_capacity_factor,
                               widths=(I, I * t.moe_num_shared_experts))

    call()
    return median_ms(call), device_ms(call)


def aria_ep_phase(device="cuda") -> dict:
    """Phase 14: expert parallelism and Aria's tensor parallelism at world
    1 over NCCL (parallel.multihost.initialize() from torchrun's
    environment for rank 0 of 1; create_mesh({"data": 1, "fsdp": 1, "tp":
    1})), ARIA_25B widths with the LM cut to ARIA_EP_LM_LAYERS layers,
    random bf16 weights from seed 0, moe_impl "ep".  Serving
    (aria_ep_serve_runs: phase 11's 4 text requests through generate_many
    at bf16 and int4_kv, its image through Sampler.generate) unsharded,
    then under moe_impl "ragged" with the ep run's tokens and routes
    forced (gate: every sampled step's logits at cosine >= SLICE_COS_TOL;
    the assignments the capacity factor 2.0 dropped are reported), then
    over the mesh with the Aria tp plan and the experts placed by expert,
    the non-expert fsdp shards gathered as the serve CLI does (gate:
    tokens and every sampled step's logits bitwise equal, the ep and tp
    collectives counted and no torch.distributed collective issued).  Then
    two GRPO steps unsharded and over the mesh under phase 12's gate
    (sharded_run_problems).  Returns the launches of the mesh's paths."""
    import torch.distributed as dist

    from spacer_tpu_torch.cli.common import serving_params
    from spacer_tpu_torch.models.aria import init_params
    from spacer_tpu_torch.models.registry import get_family
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        ARIA_PARTITION_RULES,
        aria_tp_plan,
        shard_params,
    )

    t_phase = time.perf_counter()
    tp.set_mesh(None)
    world1_env()
    multihost.initialize(device=device)
    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": 1})
    cfg = aria_ep_cfg()
    family = get_family("aria")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    proc = family.make_processor(family.mock_tokenizer(cfg.text.vocab_size),
                                 cfg)
    msgs, image = aria_ep_requests(cfg, proc)
    plain = aria_ep_serve_runs(cfg, params, proc, msgs, image)
    ragged_cfg = aria_ep_cfg(impl="ragged")
    ragged = aria_ep_serve_runs(ragged_cfg, params, proc, msgs, image,
                                replay=plain, force_drops=True)
    dropless = aria_ep_serve_runs(ragged_cfg, params, proc, msgs, image,
                                  replay=plain)
    sp = serving_params(shard_params(params, mesh, ARIA_PARTITION_RULES,
                                     aria_tp_plan(cfg))[0], mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    sharded = aria_ep_serve_runs(cfg, sp, proc, msgs, image)
    moe_ms = aria_moe_ms(sp, cfg)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    problems, paths = [], {}
    kernels = {"serve": ARIA_SERVE_KERNELS,
               "serve int4_kv": ARIA_SERVE_INT4_KV_KERNELS,
               "image": ("K1", "K2")}
    for run, a in plain.items():
        b, r = sharded[run], ragged[run]
        same_tokens = (len(a["tokens"]) == len(b["tokens"]) and all(
            torch.equal(x, y) for x, y in zip(a["tokens"], b["tokens"])))
        same_logits = (len(a["logits"]) == len(b["logits"]) and all(
            torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])))
        d = a["drops"]
        log(f"ep world 1 [{run}]: tokens equal {same_tokens}, logits bitwise "
            f"{same_logits} over {len(b['logits'])} sampled steps | decode ms "
            f"per step median, mesh vs none: "
            + (f"{statistics.median(b['decode_ms']):.2f} vs "
               f"{statistics.median(a['decode_ms']):.2f}" if a["decode_ms"]
               else "not measured")
            + f" | wall {b['wall']:.2f} vs {a['wall']:.2f} s | peak "
            f"{gib(b['peak'])} vs {gib(a['peak'])} | counted {b['collectives']}"
            f" | issued {b['issued']} | launches {b['counts']} | capacity "
            f"factor {cfg.text.moe_capacity_factor}: {d['dropped']} of "
            f"{d['assignments']} assignments dropped over {d['calls']} MoE "
            f"calls")
        bad = keep_rule_problems(a["routes"], a["keeps"], cfg)
        log(f"ep world 1 [{run}]: kept assignments against JAX's rule "
            f"(position in flat order < C) on the run's own routes: {bad} "
            f"of {len(a['keeps'])} MoE calls differ | the drops' effect, ep "
            f"vs ragged with the routes forced and nothing dropped: "
            + cosine_line(a["logits"], dropless[run]["logits"]))
        if bad:
            problems.append(f"{run}: {bad} MoE calls keep other assignments "
                            "than JAX's rule")
        logits_cosine(f"ep vs ragged [{run}]", a["logits"], r["logits"],
                      f" | ragged with the ep run's tokens, routes and drops "
                      f"forced ({r['flips']} routed rows overridden)")
        if not (same_tokens and same_logits):
            problems.append(f"{run}: tokens or logits differ")
        missing = [k for k in EP_SERVE_COLLECTIVES
                   if not b["collectives"].get(k)]
        if missing or b["issued"]:
            problems.append(f"{run}: collectives {missing} not counted, or "
                            f"issued {b['issued']}")
        if min(b["counts"][k] for k in kernels[run]) < 1:
            problems.append(f"{run}: a kernel of the path was never launched")
        paths[f"ep world 1 {run}"] = b["counts"]
    log("ep world 1: one MoE layer (moe_impl ep, 64 experts, M = 4 decode "
        f"tokens) {moe_ms[0]:.4f} ms by events, device ms "
        + ("not measured" if moe_ms[1] is None else f"{moe_ms[1]:.4f}"))
    del plain, ragged, dropless, sharded
    gc.collect()
    torch.cuda.empty_cache()

    root = pathlib.Path(__file__).resolve().parent / "build"
    tp.set_mesh(None)
    plain = fsdp_train_run(cfg, str(root / "smoke_ep_plain"), device=device,
                           make=aria_ep_trainer)
    shard = fsdp_train_run(cfg, str(root / "smoke_ep_sharded"), mesh=mesh,
                           ref=plain, device=device, make=aria_ep_trainer)
    problems += sharded_run_problems(plain, shard, "ep", EP_TRAIN_COLLECTIVES,
                                     ARIA_TRAIN_KERNELS)
    paths["ep world 1 train"] = shard["counts"]
    del plain, shard
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    tp.set_mesh(None)
    shutil.rmtree(root / "smoke_aria", ignore_errors=True)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise RuntimeError("phase 14: " + "; ".join(problems))
    return paths


def _aria_world_reference(rank, out, device="cuda"):
    """--phases 14 --world's reference, one process on card 0 without a
    mesh: full-depth ARIA_25B (moe_impl "ep") serving (aria_ep_serve_runs
    with the static generate) -> out/serve_ref.pt, one MoE layer's decode
    ms, then the GRPO reference at EP_WORLD_LM_LAYERS layers and capacity
    factor EP_WORLD_CF (_world_reference -> out/ref.pt)."""
    from spacer_tpu_torch.models.aria import init_params
    from spacer_tpu_torch.models.registry import get_family

    cfg = aria_ep_cfg(28)
    family = get_family("aria")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    proc = family.make_processor(family.mock_tokenizer(cfg.text.vocab_size),
                                 cfg)
    msgs, image = aria_ep_requests(cfg, proc)
    runs = aria_ep_serve_runs(cfg, params, proc, msgs, image, static=True)
    runs["moe_ms"] = aria_moe_ms(params, cfg)
    torch.save(runs, out + "/serve_ref.pt")
    for run, r in runs.items():
        if run != "moe_ms":
            log(f"ep world reference [{run}] (1 card, 28 layers): decode ms "
                "per step " + (f"{statistics.median(r['decode_ms']):.2f}"
                               if r["decode_ms"] else "not measured")
                + f", wall {r['wall']:.2f} s, max_memory_allocated "
                  f"{gib(r['peak'])}, drops {r['drops']}")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    _world_reference(rank, out, device, kind="aria")


def _aria_world_serve(rank, out, device="cuda"):
    """One rank of --phases 14 --world N's serving: full-depth ARIA_25B
    split over tp = N (the Aria tp plan, the non-expert fsdp shards
    gathered once), the reference's runs replayed (its tokens and routes)
    with every sampled step's logits held against its by cosine
    -> out/serve_world.pt (rank 0)."""
    from spacer_tpu_torch.cli.common import serving_params
    from spacer_tpu_torch.models.aria import init_params
    from spacer_tpu_torch.models.registry import get_family
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        ARIA_PARTITION_RULES,
        aria_tp_plan,
        shard_params,
    )

    world = multihost.process_count()
    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": world})
    ref = torch.load(out + "/serve_ref.pt", weights_only=False)
    cfg = aria_ep_cfg(28)
    family = get_family("aria")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    params = serving_params(shard_params(params, mesh, ARIA_PARTITION_RULES,
                                         aria_tp_plan(cfg))[0], mesh)
    gc.collect()
    torch.cuda.empty_cache()
    proc = family.make_processor(family.mock_tokenizer(cfg.text.vocab_size),
                                 cfg)
    msgs, image = aria_ep_requests(cfg, proc)
    runs = aria_ep_serve_runs(cfg, params, proc, msgs, image, replay=ref,
                              static=True)
    rec = {"moe_ms": aria_moe_ms(params, cfg)}
    for run, r in runs.items():
        cos = [float(torch.nn.functional.cosine_similarity(
            a, b, dim=-1).min()) for a, b in zip(r["logits"],
                                                 ref[run]["logits"])]
        rec[run] = {k: r[k] for k in ("decode_ms", "peak", "wall",
                                      "collectives", "counts", "drops")}
        rec[run].update(cos_min=min(cos), cos_median=statistics.median(cos),
                        steps=len(cos), ref_steps=len(ref[run]["logits"]))
    parts = multihost.all_gather_objects(rec)
    if rank == 0:
        torch.save(parts, out + "/serve_world.pt")


def aria_world_phase(worlds, device="cuda"):
    """`--phases 14 --world N[,M]`: the reference on card 0
    (_aria_world_reference), then for each N: N ranks serving the
    full-depth model split over tp = N (_aria_world_serve: logits cosine
    >= EP_WORLD_COS_TOL at every sampled step with the reference's tokens
    and routes replayed; per-rank peaks, decode ms per step, the MoE
    layer's decode ms); a GRPO step under "ep" at EP_WORLD_LM_LAYERS layers
    and capacity factor EP_WORLD_CF (nothing drops) over (1, 2, 2) at N =
    4, else (1, N, 1), against world 1 (phase 12's _world_rank gate); and
    at N = 4 two GRPO steps at full depth over (data 1, fsdp 4, tp 1),
    which one card cannot hold: per-rank peaks, rollout / update / apply
    s, the ep exchanges' calls, bytes and CUDA-event ms per step, drops."""
    out = str(pathlib.Path(__file__).resolve().parent / "build"
              / "smoke_ep_world")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("ep world cards (nvidia-smi): "
        + " | ".join(smi.stdout.strip().splitlines()[:max(worlds)]))
    from spacer_tpu_torch.parallel.multihost import launch_local

    os.environ["PYTHONHASHSEED"] = "0"
    # the ranks' allocators grow segments rather than keep fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    launch_local(_aria_world_reference, 1, args=(out, device), device=device,
                 timeout=1800)
    log(f"ep world reference: {time.perf_counter() - t0:.1f} s")
    ref = torch.load(out + "/serve_ref.pt", weights_only=False)
    problems = []
    for world in worlds:
        t0 = time.perf_counter()
        launch_local(_aria_world_serve, world, args=(out, device),
                     device=device, timeout=1800)
        parts = torch.load(out + "/serve_world.pt", weights_only=False)
        for r, part in enumerate(parts):
            (ev, dev), (ev1, dev1) = part["moe_ms"], ref["moe_ms"]
            log(f"tp={world} rank {r}: one MoE layer (ep, M = 4) {ev:.4f} ms "
                f"by events vs 1 card {ev1:.4f}; device ms (NCCL waits "
                "included) " + ("not measured" if dev is None
                                 else f"{dev:.4f}")
                + " vs " + ("not measured" if dev1 is None else f"{dev1:.4f}"))
            for run in ("serve", "serve int4_kv", "image", "static"):
                p, a = part[run], ref[run]
                ms = (f"{statistics.median(p['decode_ms']):.2f} vs "
                      f"{statistics.median(a['decode_ms']):.2f}"
                      if p["decode_ms"] else "not measured")
                log(f"tp={world} rank {r} [{run}]: logits cosine min "
                    f"{p['cos_min']:.5f} median {p['cos_median']:.5f} over "
                    f"{p['steps']} sampled steps (reference {p['ref_steps']}; "
                    f"tol {EP_WORLD_COS_TOL}) | decode ms per step median vs "
                    f"1 card: {ms} | wall {p['wall']:.2f} vs {a['wall']:.2f} "
                    f"s | max_memory_allocated {gib(p['peak'])} vs "
                    f"{gib(a['peak'])} | collectives {p['collectives']} | "
                    f"drops {p['drops']}")
                if not (p["steps"] == p["ref_steps"]
                        and p["cos_min"] >= EP_WORLD_COS_TOL):
                    problems.append(f"tp={world} {run} rank {r}: cosine "
                                    f"{p['cos_min']} over {p['steps']} steps")
        log(f"tp={world} serving: {time.perf_counter() - t0:.1f} s")
    train_world = max(worlds)
    shape = ({"data": 1, "fsdp": 2, "tp": 2} if train_world == 4
             else {"data": 1, "fsdp": train_world, "tp": 1})
    t0 = time.perf_counter()
    launch_local(_world_rank, train_world, args=(out, device, shape, "aria"),
                 device=device, timeout=1800)
    try:
        report_world_ranks(out, train_world, f"ep {shape}")
    except RuntimeError as e:
        problems.append(str(e))
    log(f"ep {shape}: drops per rank "
        + str([p["drops"] for p in torch.load(out + "/world.pt",
                                                weights_only=False)]))
    log(f"ep {shape} step: {time.perf_counter() - t0:.1f} s")
    if train_world == 4:
        t0 = time.perf_counter()
        launch_local(_world_rank, 4, args=(out, device, {"fsdp": 4},
                                           "aria full", False),
                     device=device, timeout=2400)
        parts = torch.load(out + "/world.pt", weights_only=False)
        for r, p in enumerate(parts):
            log(f"ep full depth (1, 4, 1) rank {r}: rollout s per step "
                f"{[round(x, 2) for x in p['rollout_s']]}, update s per step "
                f"{[round(x, 2) for x in p['update_s']]}, apply s per step "
                f"{[round(x, 2) for x in p['apply_s']]}, peak per step "
                f"{[gib(x) for x in p['peak']]}, loss {p['loss']}, drops "
                f"{p['drops']}")
            log(f"ep full depth (1, 4, 1) rank {r}: collectives per step: "
                + _collective_line(p["collectives"], 2))
            if not all(math.isfinite(x) for x in p["loss"]):
                problems.append(f"full depth rank {r}: loss {p['loss']}")
        log(f"ep full depth (1, 4, 1): {time.perf_counter() - t0:.1f} s")
    if problems:
        raise RuntimeError("phase 14 --world: " + "; ".join(problems))


# -- phases 3f and 15: ring attention and the pipeline --------------------------

# Phase 3f: ring attention's blocks at Qwen2.5-VL-7B attention widths (28
# query heads, 4 KV heads, head_dim 128): one row of RING_SEQ tokens
# left-padded by RING_PAD, cut into RING_SHARDS emulated sequence shards
RING_SEQ, RING_SHARDS, RING_PAD = 8192, 4, 300
# ... and at Aria's LM heads (ARIA_25B: 20 query and 20 KV heads of 128,
# group 1), phase 17's ring
RING_ARIA_HEADS = (20, 20)
# Phase 15 at world 1: Qwen2.5-VL-7B widths, the LM cut to PP_LM_LAYERS,
# TRAIN_G packed GRPO rows of TRAIN_PROMPT_BUCKET + TRAIN_NEW_TOKENS tokens
# (phase 5's shapes, the prompt left-padded by TRAIN_PROMPT_PAD), two steps
# per run; the pipeline at M = 2 against the plain step: the loss within
# PP_LOSS_RTOL and every tensor's gradient cosine >= PP_COS_TOL
PP_LM_LAYERS = 4
PP_LOSS_RTOL, PP_COS_TOL = 1e-3, 0.9999
PP_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv")
# --world 2,4 (a development run; never by default): full depth, the same
# rows; the ring over 2 and 4 cards, the pipeline over 2 and 4 stages and
# pipe 2 x data 2 at PP_WORLD_MICRO microbatches, step 1 against a one-card
# reference: the loss as phase 12's gate (FSDP_WORLD_LOSS_RTOL), grad_norm
# within PP_WORLD_NORM_RTOL (bf16 gradients summed in other orders), every
# compared tensor's cosine >= FSDP_WORLD_COS_TOL (the tensors of
# _world_selected)
PP_WORLD_MICRO = 4
PP_WORLD_NORM_RTOL = 1e-2
PP_WORLD_CONFIGS = {2: (("ring", {"fsdp": 2}), ("pipe", {"pipe": 2})),
                    4: (("ring", {"fsdp": 4}), ("pipe", {"pipe": 4}),
                        ("pipe", {"pipe": 2, "data": 2}))}
# --phases 17 --world 2,4 (a development run): the same configs for Aria
# (aria_ep_cfg) with its LM cut to ARIA_PP_WORLD_LAYERS, which one card
# holds with its gradients (PERF.md works out each rank's bytes); each
# config against one card running the same tokens through every MoE call
# (_pp_world_variant): the loss and cosine gates above over the gradients
# of LM layers ARIA_PP_WORLD_COMPARED and every tensor outside the layer
# list, and each layer's dropped assignments equal
ARIA_PP_WORLD_LAYERS = 12
ARIA_PP_WORLD_COMPARED = (0, 11)


def check_ring_kernels(device="cuda", heads=(28, 4), tag="") -> dict:
    """Phase 3f: K1 and K1-bwd as ring attention calls them, at `heads` =
    (query heads, KV heads) of head_dim 128 (Qwen2.5-VL-7B's by default;
    RING_ARIA_HEADS: Aria's LM, group 1) on RING_SHARDS emulated shards of
    one RING_SEQ-token row left-padded by RING_PAD: every shard's blocks and
    their LSE merge against xla_attention over the whole sequence (live
    rows); K1 on the causal diagonal block, a past block and a past block
    holding the padding against the plain version (SDPA's forward as the
    library yardstick); K1-bwd dq and dk/dv on those blocks with the MERGED
    LSE and delta against attention_bwd_from_stats (whose LSE is natural
    log: a kernel reading another unit would scale every probability), with
    torch's flash backward fed the merged LSE as the yardstick where it
    computes the same function, and its memory-efficient backward where the
    block masks keys (bwd_yardstick); and the whole ring backward against
    the whole-sequence plain gradient (rel-norm GRAD_REL_TOL per tensor)."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa
    from spacer_tpu_torch.ops import ring_attention as ra

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(15)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    (H, Hkv), D, n, S = heads, 128, RING_SHARDS, RING_SEQ
    s = S // n
    q, k, v = randn(1, S, H, D), randn(1, S, Hkv, D), randn(1, S, Hkv, D)
    mask = torch.ones((1, S), dtype=torch.bool, device=dev)
    mask[0, :RING_PAD] = False

    def sl(x, i):
        return x[:, i * s:(i + 1) * s].contiguous()

    # every emulated rank's blocks, merged; the plain whole-sequence rows
    # of each shard (its future keys are masked: they are left out)
    outs, lses, worst = [], [], 0.0
    for r in range(n):
        out = lse = None
        for src in range(r + 1):
            out, lse = ra.merge(out, lse, *ra.block_forward(
                sl(q, r), sl(k, src), sl(v, src), q_index=r, k_index=src,
                causal=True, kv_mask=sl(mask, src)))
        outs.append(out.to(bf))
        lses.append(lse)
        ref = xla_attention(sl(q, r), k[:, :(r + 1) * s], v[:, :(r + 1) * s],
                            causal=True, kv_mask=mask[:, :(r + 1) * s],
                            q_offset=r * s).float()
        live = torch.arange(r * s, (r + 1) * s, device=dev) >= RING_PAD
        diff = (outs[-1].float() - ref)[:, live].abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= BF16_TOL * (1 + ref[:, live].abs())).all()):
            raise RuntimeError(f"ring shard {r}: merged blocks disagree with "
                               f"the whole-sequence attention ({worst})")
    _sync(device)
    log(f"ring forward{tag}: {n} shards of {s}, blocks merged by LSE vs "
        f"xla_attention over {S} keys: max_abs_err {worst:.3e} on live rows "
        f"(tol {BF16_TOL:.0e} * (1 + |ref|))")

    results = {}
    # (tag, query shard, key shard): the causal diagonal block, a past block
    # of live keys, a past block holding the padding
    blocks = (("diagonal", 1, 1), ("past", 2, 1), ("past padded", 1, 0))
    for block, r, src in blocks:
        causal = src == r
        qb, kb, vb, mb = sl(q, r), sl(k, src), sl(v, src), sl(mask, src)
        live_k = int(mb.sum())
        pairs = s * (s + 1) // 2 if causal else s * live_k
        smask = mb[:, None, None, :].expand(1, 1, s, s)
        if causal:
            smask = smask & torch.ones((s, s), dtype=torch.bool,
                                       device=dev).tril()
        kw = dict(causal=causal, kv_mask=mb)
        name = f"ring {block} block S={s}{tag}"
        q_bytes = s * (H * D * 2 + H * 4)
        results[f"K1 {name}"] = compare(
            f"K1 flash_attention [{name}]",
            lambda: fa.flash_attention(qb, kb, vb, return_lse=True, **kw),
            lambda: xla_attention(qb, kb, vb, return_lse=True, **kw),
            work=(q_bytes + s * H * D * 2 + live_k * Hkv * D * 2 * 2,
                  4 * D * H * pairs),
            library_fn=lambda: sdpa_masked(qb, kb, vb, smask))
        # the backward with the merged statistics of shard r
        dout = randn(1, s, H, D)
        lse, delta = lses[r], ra.delta_of(outs[r], dout)
        args = (qb, kb, vb, dout, lse, delta)
        library = bwd_yardstick(qb, kb, vb, dout, outs[r], lse, causal,
                                smask)
        results[f"K1-bwd dq {name}"] = compare(
            f"K1-bwd dq [{name}, merged LSE]",
            lambda: fa.flash_attention_bwd_dq_from_stats(*args, **kw),
            lambda: fa.attention_bwd_from_stats(*args, **kw)[0],
            rel_norm=True, library_fn=library,
            work=(q_bytes + s * H * D * 2 * 3 + live_k * Hkv * D * 2 * 2,
                  6 * D * H * pairs))
        results[f"K1-bwd dkv {name}"] = compare(
            f"K1-bwd dk/dv [{name}, merged LSE]",
            lambda: fa.flash_attention_bwd_dkv_from_stats(*args, **kw),
            lambda: fa.attention_bwd_from_stats(*args, **kw)[1:],
            rel_norm=True, library_fn=library,
            work=(q_bytes + s * H * D * 2 * 2 + live_k * Hkv * D * 2 * 4,
                  8 * D * H * pairs))
    # the whole ring backward (every shard's blocks, kernels) against the
    # whole-sequence plain gradient; dead rows get no output gradient
    live = (torch.arange(S, device=dev) >= RING_PAD)[None, :, None, None]
    dout = randn(1, S, H, D) * live
    got = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
           for x in (q, k, v)]
    want = [torch.zeros_like(g) for g in got]
    for r in range(n):
        dr = sl(dout, r)
        delta = ra.delta_of(outs[r], dr)
        for src in range(r + 1):
            g = ra.block_backward(sl(q, r), sl(k, src), sl(v, src), dr,
                                  lses[r], delta, q_index=r, k_index=src,
                                  causal=True, kv_mask=sl(mask, src))
            for acc, x, i in zip(got, g, (r, src, src)):
                acc[:, i * s:(i + 1) * s] += x.float()
        e = (r + 1) * s
        ref = fa.attention_bwd_reference(sl(q, r), k[:, :e], v[:, :e], dr,
                                         causal=True, kv_mask=mask[:, :e],
                                         q_offset=r * s)
        want[0][:, r * s:e] += ref[0].float()
        want[1][:, :e] += ref[1].float()
        want[2][:, :e] += ref[2].float()
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    log(f"ring backward{tag}: {n} shards, K1-bwd with the merged LSE / "
        "delta vs "
        f"the whole-sequence plain gradient: rel-norm dq {rel[0]:.3e} dk "
        f"{rel[1]:.3e} dv {rel[2]:.3e} (tol {GRAD_REL_TOL:.0e}; the LSE the "
        "plain version reads is natural log)")
    if not max(rel) <= GRAD_REL_TOL:
        raise RuntimeError(f"ring backward disagrees with the plain "
                           f"gradient: {rel}")
    return results


def bwd_yardstick(q, k, v, dout, out, lse, causal, mask):
    """One torch call computing K1-bwd's function (dq, dk and dv), fed `out`
    and the LSE `lse`: torch's flash-attention backward where every key of
    `mask` ((B, 1, Sq, Skv) bool, the causal triangle included) is live,
    else its memory-efficient backward (scaled_dot_product_attention's
    EFFICIENT_ATTENTION backend) with the mask as its additive bias.  None
    (logged "-") where torch refuses the call.  Timing only."""
    if bool(mask.any(-2).all()):   # every key seen by some query: live
        return flash_bwd_yardstick(q, k, v, dout, out, lse, causal)
    return efficient_bwd_yardstick(q, k, v, dout, out, lse, mask)


def efficient_bwd_yardstick(q, k, v, dout, out, lse, mask):
    """torch's memory-efficient attention backward (dq, dk, dv in one call)
    on the GQA heads repeated, the boolean (B, 1, Sq, Skv) `mask` as its
    additive bias (-inf where False; its last dimension padded to 16 as
    scaled_dot_product_attention pads it), fed `out` and the LSE `lse` in
    its own forward's layout; None (logged "-") where it refuses the call.
    Timing only."""
    g = q.shape[2] // k.shape[2]
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    qt, ot, dt = t(q), t(out), t(dout)
    kt, vt = (t(x.repeat_interleave(g, dim=2)) for x in (k, v))
    B, H, Sq, Skv = *qt.shape[:3], kt.shape[2]
    bias = torch.zeros((B, 1, Sq, Skv - Skv % -16), dtype=q.dtype,
                       device=q.device)[..., :Skv]
    bias.masked_fill_(~mask, float("-inf"))
    bias = bias.expand(B, H, Sq, Skv)
    scale = q.shape[-1] ** -0.5
    aten = torch.ops.aten
    try:
        _, own, seed, offset = aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True, 0.0, False, scale=scale)
        fed = own.clone()
        fed[..., :Sq] = lse

        def library():
            return aten._scaled_dot_product_efficient_attention_backward(
                dt, qt, kt, vt, bias, ot, fed, seed, offset, 0.0,
                [True, True, True, False], False, scale=scale)

        library()
    except (RuntimeError, TypeError) as e:
        log(f"K1-bwd library yardstick: '-' (torch's memory-efficient "
            f"backward refused the call: {str(e).splitlines()[0][:120]})")
        return None
    return library


def flash_bwd_yardstick(q, k, v, dout, out, lse, causal):
    """torch's flash-attention backward (dq, dk, dv in one call) fed the
    merged LSE, on the GQA heads repeated (it takes no key mask: for a
    block whose keys are all live); None (logged "-") where it refuses the
    call.  Timing only."""
    g = q.shape[2] // k.shape[2]
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    qt, ot, dt = t(q), t(out), t(dout)
    kt, vt = (t(x.repeat_interleave(g, dim=2)) for x in (k, v))
    seed = torch.zeros((), dtype=torch.int64, device=q.device)

    def library():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dt, qt, kt, vt, ot, lse, None, None, q.shape[1], k.shape[1], 0.0,
            causal, seed, seed, scale=q.shape[-1] ** -0.5)

    try:
        library()
    except (RuntimeError, TypeError) as e:
        log(f"K1-bwd library yardstick: '-' (torch's flash backward refused "
            f"the merged LSE: {str(e).splitlines()[0][:120]})")
        return None
    return library


def packed_rows(cfg, device, seed: int) -> dict:
    """TRAIN_G packed GRPO rows (one prompt of TRAIN_PROMPT_BUCKET tokens
    left-padded by TRAIN_PROMPT_PAD, each row's completion of
    TRAIN_NEW_TOKENS tokens ending at a random length), random ids from
    `seed`, on `device`."""
    rng = np.random.default_rng(seed)
    G, P, C, pad = TRAIN_G, TRAIN_PROMPT_BUCKET, TRAIN_NEW_TOKENS, \
        TRAIN_PROMPT_PAD
    ids = rng.integers(10, cfg.text.vocab_size, size=(G, P + C))
    ids[:, :P] = ids[:1, :P]          # one prompt, G completions
    ids[:, :pad] = cfg.pad_token_id
    ends = rng.integers(1, C + 1, size=G)
    cmask = np.arange(C)[None] < ends[:, None]
    kv_mask = np.concatenate([np.broadcast_to(np.arange(P) >= pad, (G, P)),
                              cmask], axis=1)
    pos = np.maximum(np.cumsum(kv_mask, axis=1) - 1, 0)
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,  # noqa: E731
                                      device=device)
    return {"input_ids": t(ids, torch.long), "kv_mask": t(kv_mask, torch.bool),
            "position_ids": t(np.broadcast_to(pos, (3, G, P + C)), torch.long),
            "completion_mask": t(cmask, torch.int32),
            "advantages": t(rng.normal(size=G), torch.float32)}


def pp_model(cfg, device, seed: int = 0):
    """{"model": the LM's random bf16 params} (the packed text rows reach
    no vision tower); Aria's LM (its MoE layers) for an Aria config."""
    if getattr(cfg.text, "moe_topk", 0):
        from spacer_tpu_torch.models.aria.language import init_lm_params
    else:
        from spacer_tpu_torch.models.qwen25_vl.language import init_lm_params

    gen = torch.Generator(device=device).manual_seed(seed)
    return {"model": init_lm_params(cfg.text, generator=gen,
                                    dtype=torch.bfloat16, device=device)}


@contextlib.contextmanager
def lm_forward_by_rows(groups: int):
    """The train step's lm_forward run on `groups` equal row groups, one
    call each, their hidden states concatenated: on one card, the tokens
    every MoE call of a pipeline gets (a microbatch's rows of one data
    rank), so its capacity is the pipeline's."""
    import spacer_tpu_torch.train.step as tstep

    whole = tstep.lm_forward

    def by_rows(params, cfg, *, input_embeds, position_ids, kv_mask, **kw):
        n = input_embeds.shape[0] // groups
        return torch.cat([whole(
            params, cfg, input_embeds=input_embeds[i * n:(i + 1) * n],
            position_ids=position_ids[:, i * n:(i + 1) * n],
            kv_mask=kv_mask[i * n:(i + 1) * n], **kw)[0]
            for i in range(groups)]), None

    tstep.lm_forward = by_rows
    try:
        yield
    finally:
        tstep.lm_forward = whole


def layer_drops(keeps, span) -> dict:
    """{global layer: dropped assignments} of one forward's MoE calls
    (`keeps`: their keep masks in call order), a call's layer being span[its
    index mod len(span)] (span: the layers the forward runs, in order; a
    microbatch or row group runs them all before the next)."""
    out = {}
    for i, keep in enumerate(keeps):
        layer = span[i % len(span)]
        out[layer] = out.get(layer, 0) + int((~keep).sum())
    return out


def pp_train_run(cfg, device, kind, mesh=None, micro=1, ref=None) -> dict:
    """Two GRPO steps on phase 15's packed rows (batches of seeds 1 and 2)
    with `kind` "plain", "micro" (plain with lm_forward_by_rows(micro)),
    "ring" (attn_impl over `mesh`'s fsdp axis) or "pipe" (pipeline=(mesh,
    micro)).  Without `ref` it keeps step 1's gradients and the final params
    on the card; with `ref` (that record) each is held against it: the
    tensors that differ and per tensor the gradient cosine.  For an Aria
    config it also counts the MoE's dropped assignments: per layer over
    step 1's first forward (its reference logps), and in all."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.pipeline import shard_layers_for_pipeline
    from spacer_tpu_torch.train.optimizer import make_optimizer
    from spacer_tpu_torch.train.step import make_grpo_train_step, param_leaves

    params, ref_params = pp_model(cfg, device), pp_model(cfg, device)
    kw = {}
    if kind == "ring":
        kw["attn_impl"] = ("ring", mesh, "fsdp")
    elif kind == "pipe":
        kw["pipeline"] = (mesh, micro)
        for p in (params, ref_params):
            p["model"] = shard_layers_for_pipeline(p["model"], mesh)
    tx = make_optimizer(learning_rate=1e-5, total_steps=10,
                        moment_dtype="int8")
    named = param_leaves(params)
    names = [n for n, _ in named]
    state = tx.init([t for _, t in named], names)
    step = make_grpo_train_step(cfg, tx, beta=0.04, remat=True, **kw)
    rec = {"steps": [], "grad_bad": [], "cos": {}}

    def sink(update, grads, gnorm):
        if update:
            return
        if ref is None:
            rec["grads"] = [g.detach().clone() for g in grads]
            return
        for n, g, w in zip(names, grads, ref["grads"]):
            if not torch.equal(g, w):
                rec["grad_bad"].append(n)
            a, b = g.double().reshape(-1), w.double().reshape(-1)
            d = float(a.norm() * b.norm())
            rec["cos"][n] = float(a @ b) / d if d > 0 else float(
                bool(torch.equal(g, w)))

    GradTap(tx, sink)
    batches = [packed_rows(cfg, device, seed) for seed in (1, 2)]
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _peak(device, reset=True)
    multihost.reset_collective_stats()
    multihost.time_collectives(torch.device(device).type == "cuda")
    reset_launch_counts()
    rows = (lm_forward_by_rows(micro) if kind == "micro"
            else contextlib.nullcontext())
    with IssuedCollectives() as issued, rows, DropLog(True) as drops:
        for batch in batches:
            _sync(device)
            t = time.perf_counter()
            params, state, m = step(params, ref_params, state, batch,
                                    num_generations=TRAIN_G)
            _sync(device)
            rec["steps"].append(dict(
                {k: float(m[k]) for k in ("loss", "kl", "grad_norm")},
                s=time.perf_counter() - t))
    L = cfg.text.num_layers
    first = L * (micro if kind in ("micro", "pipe") else 1)
    rec["drops"] = dict(drops.counts(),
                        layers=layer_drops(drops.keeps[:first], range(L)))
    del drops
    rec["counts"] = launch_counts()
    rec["peak"] = _peak(device)
    rec["collectives"] = multihost.collective_stats()
    rec["issued"] = dict(issued.calls)
    multihost.time_collectives(False)
    finals = [t.detach() for _, t in param_leaves(params)]
    if ref is None:
        rec["params"] = [t.clone() for t in finals]
    else:
        rec["param_bad"] = [n for n, t, w in zip(names, finals,
                                                 ref["params"])
                            if not torch.equal(t, w)]
    del params, ref_params, state, finals
    gc.collect()
    return rec


def pp_sft_step(cfg, device, mesh, micro: int) -> dict:
    """One SFT step through the pipeline on phase 15's first rows (labels:
    the tokens the kv_mask keeps)."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel.pipeline import shard_layers_for_pipeline
    from spacer_tpu_torch.train.optimizer import make_optimizer
    from spacer_tpu_torch.train.step import make_sft_train_step, param_leaves

    params = pp_model(cfg, device)
    params["model"] = shard_layers_for_pipeline(params["model"], mesh)
    tx = make_optimizer(learning_rate=1e-5, total_steps=10,
                        moment_dtype="int8")
    named = param_leaves(params)
    state = tx.init([t for _, t in named], [n for n, _ in named])
    rows = packed_rows(cfg, device, 1)
    batch = {k: rows[k] for k in ("input_ids", "kv_mask", "position_ids")}
    batch["labels"] = torch.where(rows["kv_mask"], rows["input_ids"], -100)
    step = make_sft_train_step(cfg, tx, remat=True, pipeline=(mesh, micro))
    reset_launch_counts()
    _peak(device, reset=True)
    _sync(device)
    t = time.perf_counter()
    _, _, m = step(params, state, batch)
    _sync(device)
    rec = {"loss": float(m["loss"]), "s": time.perf_counter() - t,
           "peak": _peak(device), "counts": launch_counts()}
    del params, state
    gc.collect()
    return rec


def ring_pipe_phase(device="cuda") -> dict:
    """Phase 15: ring attention and the pipeline at world 1 over NCCL
    (torchrun's environment for rank 0 of 1), Qwen2.5-VL-7B widths with the
    LM cut to PP_LM_LAYERS, two GRPO steps each on TRAIN_G packed rows of
    phase 5's shapes: plain; with attn_impl ("ring", mesh, "fsdp") on
    create_mesh({"fsdp": 1}) and with pipeline (mesh, 1) on
    create_mesh({"pipe": 1}), both bitwise equal to the plain step (losses,
    step 1's gradients, the final params); with pipeline (mesh, 2) the loss
    within PP_LOSS_RTOL and every tensor's gradient cosine >= PP_COS_TOL
    (its GEMMs run half the rows).  Every run counts its collectives and
    issues none; every kernel of PP_KERNELS is launched.  Then one SFT step
    through the pipeline at M = 2.  Returns each run's launches."""
    import torch.distributed as dist

    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    tp.set_mesh(None)
    world1_env()
    multihost.initialize(device=device)
    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=PP_LM_LAYERS))
    ring_mesh = create_mesh({"fsdp": 1})
    pipe_mesh = create_mesh({"pipe": 1})
    plain = pp_train_run(cfg, device, "plain")
    runs = {"ring": pp_train_run(cfg, device, "ring", ring_mesh, ref=plain),
            "pipe M=1": pp_train_run(cfg, device, "pipe", pipe_mesh, 1,
                                     ref=plain),
            "pipe M=2": pp_train_run(cfg, device, "pipe", pipe_mesh, 2,
                                     ref=plain)}
    del plain["grads"], plain["params"]
    problems = []
    for name, r in (("plain", plain), *runs.items()):
        for i, st in enumerate(r["steps"]):
            log(f"phase 15 {name} step {i + 1}: loss {st['loss']!r} kl "
                f"{st['kl']!r} grad_norm {st['grad_norm']!r} | "
                f"{st['s']:.2f} s")
        log(f"phase 15 {name}: max_memory_allocated {gib(r['peak'])}, "
            f"launches {r['counts']}, collectives counted per step: "
            + (_collective_line(r["collectives"], 2) or "none")
            + f", issued {r['issued'] or 'none'}")
        if r["issued"]:
            problems.append(f"{name}: issued {r['issued']} at world 1")
        if min(r["counts"][k] for k in PP_KERNELS) < 1:
            problems.append(f"{name}: a kernel was never launched")
    for name in ("ring", "pipe M=1"):
        r = runs[name]
        same = all(a[key] == b[key] for a, b in zip(plain["steps"],
                                                     r["steps"])
                   for key in ("loss", "kl", "grad_norm"))
        log(f"phase 15 {name} vs plain: losses / kl / grad_norm bitwise "
            f"{same}, step 1 gradients differing {len(r['grad_bad'])} of "
            f"{len(r['cos'])}, final params differing {len(r['param_bad'])}")
        if not same or r["grad_bad"] or r["param_bad"]:
            problems.append(f"{name} is not bitwise the plain step: "
                            f"{r['grad_bad'][:4]} {r['param_bad'][:4]}")
        if name == "ring" and not r["collectives"].get(
                "ring_all_gather", {}).get("calls"):
            problems.append("ring: no ring_all_gather counted")
    r = runs["pipe M=2"]
    a, b = plain["steps"][0]["loss"], r["steps"][0]["loss"]
    cos = min(r["cos"].values())
    log(f"phase 15 pipe M=2 vs plain at step 1: loss {b!r} vs {a!r} (rel "
        f"{abs(b - a) / abs(a):.3e}, tol {PP_LOSS_RTOL:.0e}), gradient "
        f"cosine min {cos:.6f} over {len(r['cos'])} tensors (tol "
        f"{PP_COS_TOL}), bitwise {len(r['cos']) - len(r['grad_bad'])}")
    if abs(b - a) > PP_LOSS_RTOL * abs(a) or not cos >= PP_COS_TOL:
        problems.append(f"pipe M=2: loss {b} vs {a}, cosine {cos}")
    if not r["collectives"].get("pp_broadcast", {}).get("calls"):
        problems.append("pipe: no pp_broadcast counted")
    sft = pp_sft_step(cfg, device, pipe_mesh, 2)
    log(f"phase 15 SFT through the pipeline (M=2): loss {sft['loss']!r}, "
        f"{sft['s']:.2f} s, max_memory_allocated {gib(sft['peak'])}, "
        f"launches {sft['counts']}")
    if not math.isfinite(sft["loss"]):
        problems.append(f"SFT loss {sft['loss']}")
    dist.destroy_process_group()
    if problems:
        raise RuntimeError("phase 15: " + "; ".join(problems))
    paths = {f"train {k} world 1": r["counts"] for k, r in runs.items()}
    paths["sft pipe world 1"] = sft["counts"]
    return paths


def aria_ring_pipe_phase(device="cuda") -> dict:
    """Phase 17: Aria's capacity MoE (moe_impl "ep") under ring attention
    and the pipeline at world 1 over NCCL: ARIA_25B widths with the LM cut
    to PP_LM_LAYERS at the configured capacity factor, phase 15's two GRPO
    steps on its TRAIN_G packed rows each: plain; with the ring tuple over
    create_mesh({"fsdp": 1}) and with pipeline (mesh, 1) over
    create_mesh({"pipe": 1}), both bitwise the plain step (the MoE sees the
    whole batch); with pipeline (mesh, 2) against the plain step run on its
    two microbatches' rows one lm_forward call each (lm_forward_by_rows: the
    same capacity per call): each layer's dropped assignments equal, the
    loss within PP_LOSS_RTOL and every tensor's gradient cosine >=
    PP_COS_TOL.  Every run counts its collectives and issues none, launches
    every kernel of PP_KERNELS, and prints its drops; the phase fails if
    nothing dropped.  Returns each run's launches."""
    import torch.distributed as dist

    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    tp.set_mesh(None)
    world1_env()
    multihost.initialize(device=device)
    cfg = aria_ep_cfg(PP_LM_LAYERS)
    ring_mesh = create_mesh({"fsdp": 1})
    pipe_mesh = create_mesh({"pipe": 1})
    plain = pp_train_run(cfg, device, "plain")
    runs = {"ring": pp_train_run(cfg, device, "ring", ring_mesh, ref=plain),
            "pipe M=1": pp_train_run(cfg, device, "pipe", pipe_mesh, 1,
                                     ref=plain)}
    del plain["grads"], plain["params"]
    gc.collect()
    micro = pp_train_run(cfg, device, "micro", micro=2)
    runs["pipe M=2"] = pp_train_run(cfg, device, "pipe", pipe_mesh, 2,
                                    ref=micro)
    del micro["grads"], micro["params"]
    problems = []
    for name, r in (("plain", plain), ("plain by microbatch (M=2)", micro),
                    *runs.items()):
        for i, st in enumerate(r["steps"]):
            log(f"phase 17 {name} step {i + 1}: loss {st['loss']!r} kl "
                f"{st['kl']!r} grad_norm {st['grad_norm']!r} | "
                f"{st['s']:.2f} s")
        d = r["drops"]
        log(f"phase 17 {name}: capacity factor "
            f"{cfg.text.moe_capacity_factor}, {d['dropped']} of "
            f"{d['assignments']} assignments dropped over {d['calls']} MoE "
            f"calls; step 1's first forward by layer {d['layers']} | "
            f"max_memory_allocated {gib(r['peak'])}, launches {r['counts']}, "
            "collectives counted per step: "
            + (_collective_line(r["collectives"], 2) or "none")
            + f", issued {r['issued'] or 'none'}")
        if r["issued"]:
            problems.append(f"{name}: issued {r['issued']} at world 1")
        if min(r["counts"][k] for k in PP_KERNELS) < 1:
            problems.append(f"{name}: a kernel was never launched")
        if not d["dropped"]:
            problems.append(f"{name}: no assignment dropped")
    for name in ("ring", "pipe M=1"):
        r = runs[name]
        same = all(a[key] == b[key] for a, b in zip(plain["steps"],
                                                     r["steps"])
                   for key in ("loss", "kl", "grad_norm"))
        log(f"phase 17 {name} vs plain: losses / kl / grad_norm bitwise "
            f"{same}, step 1 gradients differing {len(r['grad_bad'])} of "
            f"{len(r['cos'])}, final params differing {len(r['param_bad'])},"
            f" drops equal {r['drops'] == plain['drops']}")
        if (not same or r["grad_bad"] or r["param_bad"]
                or r["drops"] != plain["drops"]):
            problems.append(f"{name} is not bitwise the plain step: "
                            f"{r['grad_bad'][:4]} {r['param_bad'][:4]}")
    r = runs["pipe M=2"]
    a, b = micro["steps"][0]["loss"], r["steps"][0]["loss"]
    cos = min(r["cos"].values())
    log(f"phase 17 pipe M=2 vs plain by microbatch at step 1: loss {b!r} vs "
        f"{a!r} (rel {abs(b - a) / abs(a):.3e}, tol {PP_LOSS_RTOL:.0e}), "
        f"gradient cosine min {cos:.6f} over {len(r['cos'])} tensors (tol "
        f"{PP_COS_TOL}), bitwise {len(r['cos']) - len(r['grad_bad'])}; "
        f"drops by layer {r['drops']['layers']} vs {micro['drops']['layers']}"
        f" (the whole batch's {plain['drops']['layers']})")
    if abs(b - a) > PP_LOSS_RTOL * abs(a) or not cos >= PP_COS_TOL:
        problems.append(f"pipe M=2: loss {b} vs {a}, cosine {cos}")
    if r["drops"]["layers"] != micro["drops"]["layers"]:
        problems.append("pipe M=2: drops by layer differ from the plain "
                        "step's by microbatch")
    dist.destroy_process_group()
    if problems:
        raise RuntimeError("phase 17: " + "; ".join(problems))
    return {f"train aria {k} world 1": r["counts"] for k, r in runs.items()}


def _pp_world_params(cfg, device, kind, mesh):
    """(params, the global indices of the layers they hold) of a --world
    run: the LM from phase 15's seed, whole, or cut to the stage's
    layers."""
    from spacer_tpu_torch.parallel.pipeline import (
        shard_layers_for_pipeline,
        stage_layers,
    )

    params = pp_model(cfg, device)
    if kind != "pipe":
        return params, range(cfg.text.num_layers)
    params["model"] = shard_layers_for_pipeline(params["model"], mesh)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return params, stage_layers(cfg.text.num_layers, mesh)


def _pp_world_model(model: str):
    """(config, the predicate of the tensors whose gradients are compared)
    of a --world run: "qwen" (phase 15: Qwen2.5-VL-7B at full depth,
    _world_selected) or "aria" (phase 17: aria_ep_cfg at
    ARIA_PP_WORLD_LAYERS, LM layers ARIA_PP_WORLD_COMPARED and every tensor
    outside the layer list)."""
    if model == "aria":
        def compared(name):
            parts = name.split("/")
            return (parts[:2] != ["model", "layers"]
                    or int(parts[2]) in ARIA_PP_WORLD_COMPARED)

        return aria_ep_cfg(ARIA_PP_WORLD_LAYERS), compared
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    return QWEN25_VL_7B, _world_selected


def _pp_world_variant(model: str, kind: str, shape: dict) -> str:
    """The one-card reference a --world config is held against: the whole
    batch ("plain"); for Aria's pipelines the rows of each (microbatch,
    data rank) one lm_forward call each ("rows N", lm_forward_by_rows), the
    tokens each of its MoE calls gets."""
    if model == "aria" and kind == "pipe":
        return f"rows {PP_WORLD_MICRO * shape.get('data', 1)}"
    return "plain"


def _pp_world_step(cfg, device, params, kind, mesh, groups=1, span=None):
    """-> fn(replay=None, record=True) running one loss-and-gradients step
    of --world's packed rows (the policy its own reference), returning
    (loss, grad_norm, names, grads, moe); `kind` "plain", "ring", "pipe" or
    "rows" (plain on `groups` row groups, lm_forward_by_rows); `span`: the
    layers the params hold; `replay`: every MoE call's routes of an earlier
    step, forced (RouteLog).  moe (None without `record`): of the MoE calls
    of the step's reference-logps forward, "drops" {layer: dropped
    assignments}, "rule_bad" (the calls whose kept set is not JAX's
    capacity rule on their own routes and tokens, keep_rule_problems) and
    "tokens" (the token counts the calls got); of all its calls, "routes"
    (each call's experts, on the host) and "flips" (the rows whose own
    routes the replay overrode)."""
    from spacer_tpu_torch.parallel import pipeline as pp
    from spacer_tpu_torch.train.optimizer import global_norm, make_optimizer
    from spacer_tpu_torch.train.step import make_grpo_train_step, param_leaves

    kw = ({"attn_impl": ("ring", mesh, "fsdp")} if kind == "ring" else
          {"pipeline": (mesh, PP_WORLD_MICRO)} if kind == "pipe" else {})
    step = make_grpo_train_step(cfg, make_optimizer(), beta=0.04, remat=True,
                                **kw)
    batch = packed_rows(cfg, device, 1)
    names = [n for n, _ in param_leaves(params)]
    span = list(span if span is not None else range(cfg.text.num_layers))
    first = len(span) * (PP_WORLD_MICRO if kind == "pipe" else groups)

    def run(replay=None, record=True):
        rows = (lm_forward_by_rows(groups) if kind == "rows"
                else contextlib.nullcontext())
        logs = ((DropLog(True), RouteLog(replay)) if record or replay
                else (contextlib.nullcontext(), contextlib.nullcontext()))
        with rows, logs[0] as drops, logs[1] as routes:
            ref = step.ref_logps_fn(params, batch, num_generations=TRAIN_G)
            loss, _, grads = step.loss_and_grads(params, ref, batch,
                                                 num_generations=TRAIN_G)
        norm = (pp.global_norm(grads, names, mesh) if kind == "pipe"
                else global_norm(grads))
        moe = None
        if record:
            keeps, idx = drops.keeps[:first], routes.idx[:first]
            moe = {"drops": layer_drops(keeps, span),
                   "rule_bad": keep_rule_problems(idx, keeps, cfg),
                   "tokens": sorted({int(r.shape[0]) for r in idx}),
                   "routes": [r.cpu() for r in routes.idx],
                   "flips": routes.flips}
        return float(loss), float(norm), names, grads, moe

    return run


def _pp_world_reference(rank, out, device="cuda", model="qwen"):
    """--world's references, one card without a mesh, each variant of
    _pp_world_variant: the loss, grad_norm, drops and the compared
    gradients of the step on its first rows (the plain one's routes too),
    its second (warm) step timed -> out/ref.pt ({variant: record})."""
    cfg, compared = _pp_world_model(model)
    variants = sorted({_pp_world_variant(model, kind, shape)
                       for configs in PP_WORLD_CONFIGS.values()
                       for kind, shape in configs})
    params, _ = _pp_world_params(cfg, device, "plain", None)
    recs = {}
    for variant in variants:
        kind, groups = ("plain", 1) if variant == "plain" else (
            "rows", int(variant.split()[1]))
        run = _pp_world_step(cfg, device, params, kind, None, groups)
        loss, norm, names, grads, moe = run()
        drops = moe["drops"]
        if variant != "plain":   # only a ring replays routes
            moe["routes"] = []
        recs[variant] = rec = {
            "loss": loss, "grad_norm": norm, "drops": drops, "moe": moe,
            "adv_scale": float(packed_rows(cfg, device, 1)[
                "advantages"].abs().mean()),
            "grads": {n: g.cpu() for n, g in zip(names, grads)
                      if compared(n)}}
        del grads
        gc.collect()
        # the second (warm) step timed, as the ranks' is
        _peak(device, reset=True)
        _sync(device)
        t = time.perf_counter()
        run(record=False)
        _sync(device)
        rec["s"], rec["peak"] = time.perf_counter() - t, _peak(device)
        log(f"ring / pipe world reference {variant} (1 card): loss {loss!r} "
            f"grad_norm {norm!r}, {rec['s']:.2f} s, max_memory_allocated "
            f"{gib(rec['peak'])}" + (f", drops by layer {drops}" if drops
                                     else ""))
    torch.save(recs, out + "/ref.pt")


def idle_share(fn, device) -> tuple:
    """(wall s, share of the wall with no compute kernel running) of one
    call of fn under torch.profiler: the union of the CUDA kernels' spans
    other than NCCL's (a P2P or collective kernel also spans its wait)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "nccl" not in e.name.lower())
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, 1.0 - busy / 1e6 / wall if wall > 0 else 0.0


def _pp_world_rank(rank, out, device="cuda", model="qwen"):
    """One rank of --world N: PP_WORLD_CONFIGS[N] in turn, each three
    loss-and-gradients steps: the first held against its reference, the
    second timed (its peak and collectives), the third profiled; a ring's
    first step again with the reference's routes forced ("forced": its
    attention rounds otherwise than one card's, which flips near-tied
    routes, and a capacity MoE's drops and outputs follow every flip)."""
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.train.step import param_leaves

    world = multihost.process_count()
    cfg, _ = _pp_world_model(model)
    refs = torch.load(out + "/ref.pt", weights_only=False)
    recs = {}
    for kind, shape in PP_WORLD_CONFIGS[world]:
        tag = f"{kind} {shape}"
        ref = refs[_pp_world_variant(model, kind, shape)]
        mesh = create_mesh(shape)
        params, span = _pp_world_params(cfg, device, kind, mesh)
        run = _pp_world_step(cfg, device, params, kind, mesh, span=span)
        held = sum(t.numel() * t.element_size()
                   for _, t in param_leaves(params))
        def cosines(names, grads):
            cos = {}
            for n, g in zip(names, grads):
                parts = n.split("/")
                if parts[:2] == ["model", "layers"]:
                    parts[2] = str(span[int(parts[2])])
                full = "/".join(parts)
                w = ref["grads"].get(full)
                if w is None or (kind == "pipe" and mesh.coords["data"]):
                    continue
                a = g.double().reshape(-1)
                b = w.to(g.device).double().reshape(-1)
                d = float(a.norm() * b.norm())
                cos[full] = (float(a @ b) / d if d > 0
                             else float(bool(torch.equal(a, b))))
            return cos

        loss, norm, names, grads, moe = run()
        # the routes this rank's MoE calls chose that the reference's did
        # not (a ring's calls are the reference's in order; a pipeline
        # stage's are its own rows of its own layers)
        flips = (sum(int((torch.sort(a, -1).values
                          != torch.sort(b, -1).values).any(-1).sum())
                     for a, b in zip(moe["routes"], ref["moe"]["routes"]))
                 if kind == "ring" else 0)
        rec = {"loss": loss, "grad_norm": norm, "held": held,
               "cos": cosines(names, grads), "drops": moe["drops"],
               "rule_bad": moe["rule_bad"], "tokens": moe["tokens"],
               "flips": flips}
        del grads, moe
        gc.collect()
        if kind == "ring" and ref["moe"]["routes"]:
            loss, norm, names, grads, moe = run(
                replay=[r.to(device) for r in ref["moe"]["routes"]])
            rec["forced"] = {"loss": loss, "grad_norm": norm,
                             "cos": cosines(names, grads),
                             "drops": moe["drops"], "flips": moe["flips"]}
            del grads, moe
            gc.collect()
        # the second (warm) step: time, peak and collectives
        _peak(device, reset=True)
        multihost.reset_collective_stats()
        multihost.time_collectives(torch.device(device).type == "cuda")
        _sync(device)
        t = time.perf_counter()
        run(record=False)
        _sync(device)
        rec["s"] = time.perf_counter() - t
        multihost.time_collectives(False)
        rec["collectives"] = multihost.collective_stats()
        rec["peak"] = _peak(device)
        rec["profiled_s"], rec["idle"] = idle_share(
            lambda: run(record=False), device)
        if kind == "pipe":
            S = mesh.shape["pipe"]
            rec["bubble"] = (S - 1) / (PP_WORLD_MICRO + S - 1)
        recs[tag] = rec
        del params, run
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    parts = multihost.all_gather_objects(recs)
    if rank == 0:
        torch.save(parts, out + f"/world{world}.pt")


def _pp_world_report(world, kind, tag, ranks, ref) -> list:
    """Logs one --world config's ranks against its reference -> problems.
    Gated: the loss (FSDP_WORLD_LOSS_RTOL of max(|loss|, the advantages'
    scale)), grad_norm (PP_WORLD_NORM_RTOL), every compared tensor's cosine
    (FSDP_WORLD_COS_TOL) and each layer's drops (a pipeline's summed over
    its ranks) equal, a ring's with the reference's routes forced (its own
    are reported); every MoE call's kept set JAX's capacity rule, and a
    ring's calls the whole batch."""
    gated = [r.get("forced", r) for r in ranks]
    scale = max(abs(ref["loss"]), ref["adv_scale"])
    problems, cos, drops = [], {}, collections.Counter()
    for r in (gated if kind == "pipe" else gated[:1]):
        drops.update(r["drops"])
    if dict(drops) != ref["drops"]:
        problems.append(f"{tag}: drops by layer {dict(drops)} vs "
                        f"{ref['drops']}")
    if any(r["rule_bad"] for r in ranks):
        problems.append(f"{tag}: kept sets off the capacity rule")
    if kind == "ring" and any(r["tokens"] != ref["moe"]["tokens"]
                              for r in ranks):
        problems.append(f"{tag}: an MoE call without the whole batch")
    for i, (rec, g) in enumerate(zip(ranks, gated)):
        cos.update(g["cos"])
        log(f"{tag} world {world} rank {i}: loss {rec['loss']!r} grad_norm "
            f"{rec['grad_norm']!r} | {rec['s']:.2f} s per step, idle share "
            f"{rec['idle']:.3f} (of a profiled step, "
            f"{rec['profiled_s']:.2f} s)"
            + (f" (bubble {rec['bubble']:.3f})" if "bubble" in rec else "")
            + f" | max_memory_allocated {gib(rec['peak'])}, params held "
            f"{gib(rec['held'])} | per step: "
            + _collective_line(rec["collectives"], 1))
        if abs(g["loss"] - ref["loss"]) > FSDP_WORLD_LOSS_RTOL * scale:
            problems.append(f"{tag} rank {i}: loss {g['loss']}")
        if abs(g["grad_norm"] - ref["grad_norm"]) > (
                PP_WORLD_NORM_RTOL * ref["grad_norm"]):
            problems.append(f"{tag} rank {i}: grad_norm {g['grad_norm']}")
    worst = min(cos.values()) if cos else float("nan")
    own = ""
    if "forced" in ranks[0]:
        own_cos = min(c for r in ranks for c in r["cos"].values())
        own = (f" | its own routes: {ranks[0]['flips']} of the step's "
               f"routed rows other than the reference's, drops by layer "
               f"{ranks[0]['drops']}, grad_norm {ranks[0]['grad_norm']!r}, "
               f"cosine min {own_cos:.6f}")
    log(f"{tag} world {world} vs 1 card"
        + (" (the reference's routes forced)" if own else "")
        + f": loss {gated[0]['loss']!r} vs {ref['loss']!r}, grad_norm "
        f"{gated[0]['grad_norm']!r} vs {ref['grad_norm']!r}, gradient cosine"
        f" min {worst:.6f} over {len(cos)} of {len(ref['grads'])} tensors"
        + (f", drops by layer {dict(drops)} vs {ref['drops']} (tokens per "
           f"MoE call {ranks[0]['tokens']}, kept sets off the capacity rule "
           f"{sum(r['rule_bad'] for r in ranks)})" if ref["drops"] else "")
        + own)
    if len(cos) != len(ref["grads"]) or not worst >= FSDP_WORLD_COS_TOL:
        problems.append(f"{tag}: cosines {worst} over {len(cos)}")
    return problems


def ring_pipe_world_phase(worlds, device="cuda", model="qwen"):
    """`--phases 15 --world 2,4` (model "qwen") and `--phases 17 --world
    2,4` ("aria"): the one-card references on card 0 (_pp_world_variant),
    then each world's PP_WORLD_CONFIGS (parallel.multihost.launch_local,
    NCCL): per config and rank the loss, grad_norm and every compared
    tensor's gradient cosine against its reference (the gates above), for
    Aria each layer's dropped assignments (a pipeline's summed over its
    ranks: each runs its rows of its layers) against the reference's, the
    peak memory and the parameter bytes a rank holds, s per step, for the
    pipeline the bubble share (S - 1) / (M + S - 1) beside the measured
    idle share, and the P2P and collective calls, bytes and CUDA-event ms
    per step."""
    out = str(pathlib.Path(__file__).resolve().parent / "build"
              / f"smoke_pp_world_{model}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    log("ring / pipe world cards (nvidia-smi): " + " | ".join(
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True
                       ).stdout.strip().splitlines()[:max(worlds)]))
    from spacer_tpu_torch.parallel.multihost import launch_local

    launch_local(_pp_world_reference, 1, args=(out, device, model),
                 device=device, timeout=900)
    refs = torch.load(out + "/ref.pt", weights_only=False)
    problems = []
    for world in worlds:
        launch_local(_pp_world_rank, world, args=(out, device, model),
                     device=device, timeout=1500)
        parts = torch.load(out + f"/world{world}.pt", weights_only=False)
        for (kind, shape), tag in zip(PP_WORLD_CONFIGS[world], parts[0]):
            ref = refs[_pp_world_variant(model, kind, shape)]
            problems += _pp_world_report(world, kind, tag, [p[tag] for p in
                                                            parts], ref)
    for variant, ref in refs.items():
        log(f"ring / pipe world reference {variant} (1 card): {ref['s']:.2f} "
            f"s per warm step, max_memory_allocated {gib(ref['peak'])}")
    if problems:
        raise RuntimeError(f"phase {15 if model == 'qwen' else 17} --world: "
                           + "; ".join(problems))


# -- phase 16: the ViTs' ring on K1 / K1-bwd at head_dim 80, experts placed
# over data, speculative rollouts over split rows ----------------------------

# 16's kernels: the Qwen2.5-VL-7B tower's training video as its ring blocks
# see it (VIT_RING_CHUNKS frame chunks of VIT_RING_CHUNK tokens as the
# batch, 16 heads of 80; the whole chunk at world 1, and VIT_RING_SHARDS
# emulated shards' blocks with the whole chunk's statistics), and Aria's
# tower backward at head_dim 72 ((1, ARIA_TOWER_SEQ, 16, 72), the first
# ARIA_TOWER_LIVE keys live, phase 3c's forward shape)
VIT_RING_CHUNKS, VIT_RING_CHUNK, VIT_RING_SHARDS = 8, 480, (2, 4)
ARIA_TOWER_SEQ, ARIA_TOWER_LIVE = 4900, 2800
# 16's step: Qwen2.5-VL-7B's whole 32-block ViT and PP_LM_LAYERS of the 28
# LM layers, TRAIN_G packed rows of one video prompt (grid VIT_RING_GRID: 8
# frame chunks of 480 patches; VIT_RING_PROMPT tokens, then
# TRAIN_NEW_TOKENS), loss and gradients with the ring tuple at world 1
# against the K4 path: loss within PP_LOSS_RTOL, every tensor's gradient
# cosine >= VIT_RING_COS_TOL
VIT_RING_GRID = (8, 20, 24)
VIT_RING_PROMPT = 1024
VIT_RING_COS_TOL = 0.999
VIT_RING_KERNELS = ("K1 d80", "K1-bwd dq d80", "K1-bwd dkv d80", "K3")
# the LM's k_proj biases: RoPE turns the bias into a score term that
# varies with the key's position, but over a softmax row most of it
# cancels, so their gradients are small and their cosines the first to
# show rounding (logged beside the other tensors' norms)
SMALL_GRAD = "self_attn/k_proj/bias"
# --world N's gate: a tensor below VIT_RING_COS_TOL against one card may
# deviate (1 - cosine) up to VIT_RING_CTRL_FACTOR x N times the world-1
# ring's deviation (vit_world_gate)
VIT_RING_CTRL_FACTOR = 4
# --phases 16 --world 2,4: Aria's GRPO step (phase 14's --world gate) with
# the experts over data at (2, 1, 1) and over data x fsdp at (2, 2, 1); a
# speculative rollout (SPEC_K drafts) of SPEC_WORLD_PROMPTS text prompts x
# SPEC_WORLD_G at full 7B depth over (N, 1, 1) against card 0 alone; the
# step above at full depth with the ring over N cards against one card's K4
# path (phase 15's --world gates)
SPEC_WORLD_PROMPTS, SPEC_WORLD_G, SPEC_WORLD_NEW_TOKENS = 4, 4, 128
EP_WORLD_AXES = {2: ("aria data", {"data": 2}),
                 4: ("aria batch", {"data": 2, "fsdp": 2})}


def check_vit_ring_kernels(device="cuda") -> dict:
    """Phase 16's kernels: K1 at head_dim 80 over the whole frame chunks
    (the ring of one rank) and on a block of each emulated shard count (the
    first shard's queries, the last shard's keys); K1-bwd dq and dk/dv at
    80 from the given statistics (the ring's entries) over the whole chunks
    and on those blocks with the whole chunk's LSE and delta, and from
    their own statistics; K1-bwd at 72 on Aria's tower from its own
    statistics (its autograd backward) and through the given-statistics
    entries.  Each against its plain version, SDPA's forward and torch's
    flash backward as the yardsticks where they compute the same
    function.  -> the kernels line's entries of HEAD_DIM_IDS."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)

    def attn_work(B, Sq, Skv, H, D, pairs, q_io, kv_in, kv_out, factor,
                  stats, live=None):
        """(bytes, ops) of an attention pass moving q_io bf16 tensors of the
        query side, reading kv_in of the key side (its `live` keys),
        writing kv_out, and moving `stats` f32 per-row statistics (the
        forward writes the LSE: 1; a backward from given statistics reads
        the LSE and delta: 2; from its own, the LSE: 1): factor x D x H
        operations per visible pair."""
        live = Skv if live is None else live
        return (q_io * B * Sq * H * D * 2 + kv_in * B * live * H * D * 2
                + kv_out * B * Skv * H * D * 2 + stats * B * H * Sq * 4,
                factor * D * H * pairs)

    results = {}
    H, D, n, S = 16, 80, VIT_RING_CHUNKS, VIT_RING_CHUNK
    q, k, v, dout = (randn(n, S, H, D) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    delta = fa._delta(out, dout)
    name = f"({n}, {S}, {H}, {D})"
    results["K1 d80"] = compare(
        f"K1 flash_attention [head_dim 80, the ViT's ring at world 1 {name}]",
        lambda: fa.flash_attention(q, k, v, return_lse=True),
        lambda: xla_attention(q, k, v, return_lse=True),
        work=attn_work(n, S, S, H, D, n * S * S, 2, 2, 0, 4, 1),
        library_fn=lambda: sdpa(q, k, v))
    args = (q, k, v, dout, lse, delta)
    library = flash_bwd_yardstick(q, k, v, dout, out, lse, False)
    results["K1-bwd dq d80"] = compare(
        f"K1-bwd dq [head_dim 80 from given statistics {name}]",
        lambda: fa.flash_attention_bwd_dq_from_stats(*args),
        lambda: fa.attention_bwd_from_stats(*args)[0], rel_norm=True,
        library_fn=library,
        work=attn_work(n, S, S, H, D, n * S * S, 3, 2, 0, 6, 2))
    results["K1-bwd dkv d80"] = compare(
        f"K1-bwd dk/dv [head_dim 80 from given statistics {name}]",
        lambda: fa.flash_attention_bwd_dkv_from_stats(*args),
        lambda: fa.attention_bwd_from_stats(*args)[1:], rel_norm=True,
        library_fn=library,
        work=attn_work(n, S, S, H, D, n * S * S, 2, 2, 2, 8, 2))
    own = (q, k, v, out, lse, dout)
    compare(f"K1-bwd dq [head_dim 80 from its own statistics {name}]",
            lambda: fa.flash_attention_bwd_dq(*own),
            lambda: fa.attention_bwd_reference(q, k, v, dout)[0],
            rel_norm=True,
            work=attn_work(n, S, S, H, D, n * S * S, 4, 2, 0, 6, 1))
    compare(f"K1-bwd dk/dv [head_dim 80 from its own statistics {name}]",
            lambda: fa.flash_attention_bwd_dkv(*own),
            lambda: fa.attention_bwd_reference(q, k, v, dout)[1:],
            rel_norm=True,
            work=attn_work(n, S, S, H, D, n * S * S, 3, 2, 2, 8, 1))
    for shards in VIT_RING_SHARDS:
        s = S // shards
        qb, dob = q[:, :s].contiguous(), dout[:, :s].contiguous()
        kb, vb = k[:, S - s:].contiguous(), v[:, S - s:].contiguous()
        st = (lse[:, :, :s].contiguous(), delta[:, :, :s].contiguous())
        tag = f"a ring block of {shards} shards ({n}, {s}, {H}, {D})"
        compare(f"K1 flash_attention [head_dim 80, {tag}]",
                lambda: fa.flash_attention(qb, kb, vb, return_lse=True),
                lambda: xla_attention(qb, kb, vb, return_lse=True),
                work=attn_work(n, s, s, H, D, n * s * s, 2, 2, 0, 4, 1),
                library_fn=lambda: sdpa(qb, kb, vb))
        bargs = (qb, kb, vb, dob, *st)
        compare(f"K1-bwd dq [head_dim 80, {tag}, the chunk's LSE]",
                lambda: fa.flash_attention_bwd_dq_from_stats(*bargs),
                lambda: fa.attention_bwd_from_stats(*bargs)[0],
                rel_norm=True,
                work=attn_work(n, s, s, H, D, n * s * s, 3, 2, 0, 6, 2))
        compare(f"K1-bwd dk/dv [head_dim 80, {tag}, the chunk's LSE]",
                lambda: fa.flash_attention_bwd_dkv_from_stats(*bargs),
                lambda: fa.attention_bwd_from_stats(*bargs)[1:],
                rel_norm=True,
                work=attn_work(n, s, s, H, D, n * s * s, 2, 2, 2, 8, 2))
    del q, k, v, dout, out, lse, delta, args, own
    # Aria's tower: its autograd backward runs the own-statistics kernels
    S, D, live = ARIA_TOWER_SEQ, 72, ARIA_TOWER_LIVE
    q, k, v, dout = (randn(1, S, H, D) for _ in range(4))
    mask = torch.zeros((1, S), dtype=torch.bool, device=dev)
    mask[0, :live] = True
    kw = dict(kv_mask=mask)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    name = f"Aria's tower (1, {S}, {H}, {D}), {live} live keys"
    own = (q, k, v, out, lse, dout)
    library = efficient_bwd_yardstick(
        q, k, v, dout, out, lse, mask[:, None, None].expand(1, 1, S, S))
    results["K1-bwd dq d72"] = compare(
        f"K1-bwd dq [head_dim 72, {name}]",
        lambda: fa.flash_attention_bwd_dq(*own, **kw),
        lambda: fa.attention_bwd_reference(q, k, v, dout, **kw)[0],
        rel_norm=True, library_fn=library,
        work=attn_work(1, S, S, H, D, S * live, 4, 2, 0, 6, 1, live))
    results["K1-bwd dkv d72"] = compare(
        f"K1-bwd dk/dv [head_dim 72, {name}]",
        lambda: fa.flash_attention_bwd_dkv(*own, **kw),
        lambda: fa.attention_bwd_reference(q, k, v, dout, **kw)[1:],
        rel_norm=True, library_fn=library,
        work=attn_work(1, S, S, H, D, S * live, 3, 2, 2, 8, 1, live))
    sargs = (q, k, v, dout, lse, fa._delta(out, dout))
    compare(f"K1-bwd dq [head_dim 72 from given statistics, {name}]",
            lambda: fa.flash_attention_bwd_dq_from_stats(*sargs, **kw),
            lambda: fa.attention_bwd_from_stats(*sargs, **kw)[0],
            rel_norm=True,
            work=attn_work(1, S, S, H, D, S * live, 3, 2, 0, 6, 2, live))
    compare(f"K1-bwd dk/dv [head_dim 72 from given statistics, {name}]",
            lambda: fa.flash_attention_bwd_dkv_from_stats(*sargs, **kw),
            lambda: fa.attention_bwd_from_stats(*sargs, **kw)[1:],
            rel_norm=True,
            work=attn_work(1, S, S, H, D, S * live, 2, 2, 2, 8, 2, live))
    del q, k, v, dout, out, lse, own, sargs, library
    gc.collect()
    torch.cuda.empty_cache()
    return results


def video_packed_rows(cfg, device, seed: int, rows: int = TRAIN_G) -> tuple:
    """(`rows` packed GRPO rows of one video prompt, grid_thw): the prompt
    VIT_RING_PROMPT tokens left-padded around the VIT_RING_GRID video's
    placeholders, each row's completion of TRAIN_NEW_TOKENS ending at a
    random length, mrope positions, random bf16 pixels, all from `seed`."""
    from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

    rng = np.random.default_rng(seed)
    t, h, w = VIT_RING_GRID
    n_video = t * h * w // cfg.vision.spatial_merge_unit
    prompt = ([10, 11, cfg.vision_start_token_id] + [cfg.video_token_id]
              * n_video + [cfg.vision_end_token_id, 20, 21])
    pad, C = VIT_RING_PROMPT - len(prompt), TRAIN_NEW_TOKENS
    ids = np.array([[cfg.pad_token_id] * pad + prompt])
    mask = np.array([[0] * pad + [1] * len(prompt)])
    pos, deltas = get_rope_index(cfg, ids,
                                 video_grid_thw=np.array([VIT_RING_GRID]),
                                 attention_mask=mask)
    comp = rng.integers(10, cfg.text.vocab_size, size=(rows, C))
    ends = rng.integers(1, C + 1, size=rows)
    cmask = np.arange(C)[None] < ends[:, None]
    comp_pos = np.broadcast_to(deltas.reshape(1, 1) + VIT_RING_PROMPT
                               + np.arange(C)[None], (rows, C))
    t_ = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,  # noqa: E731
                                       device=device)
    batch = {
        "input_ids": t_(np.concatenate([np.repeat(ids, rows, 0), comp], 1),
                        torch.long),
        "kv_mask": t_(np.concatenate([np.repeat(mask, rows, 0), cmask], 1),
                      torch.bool),
        "position_ids": t_(np.concatenate([
            np.repeat(pos, rows, 1),
            np.broadcast_to(comp_pos[None], (3, rows, C))], 2), torch.long),
        "completion_mask": t_(cmask, torch.int32),
        "advantages": t_(rng.normal(size=rows), torch.float32),
        "pixel_values": torch.randn(
            (t * h * w, cfg.vision.patch_dim), device=device,
            generator=torch.Generator(device=device).manual_seed(seed)
        ).to(torch.bfloat16)}
    return batch, [VIT_RING_GRID]


def grad_cosine(x, y) -> float:
    """Cosine of two gradients (f64); 1.0 where both are zero."""
    x, y = x.double().reshape(-1), y.double().reshape(-1)
    d = float(x.norm() * y.norm())
    return float(x @ y) / d if d > 0 else float(bool(torch.equal(x, y)))


def small_grads_line(names, grads, cos) -> str:
    """The SMALL_GRAD tensors' gradient norms and cosines beside the median
    norm of the other tensors' gradients."""
    norms = {n: float(g.double().norm()) for n, g in zip(names, grads)}
    small = [n for n in norms if n.endswith(SMALL_GRAD)]
    rest = sorted(v for n, v in norms.items() if n not in small)
    return (f"{SMALL_GRAD}: norm {min(norms[n] for n in small):.3e}-"
            f"{max(norms[n] for n in small):.3e} (the other tensors' median "
            f"{rest[len(rest) // 2]:.3e}), cosine min "
            f"{min(cos[n] for n in small):.6f} over {len(small)}")


def vit_ring_step(cfg, device, params, impl=None):
    """-> fn() running the loss and gradients of phase 16's video rows
    (seed 1, the policy its own reference) with attn_impl `impl`,
    returning (loss, grad_norm, names, grads)."""
    from spacer_tpu_torch.train.optimizer import global_norm, make_optimizer
    from spacer_tpu_torch.train.step import make_grpo_train_step, param_leaves

    step = make_grpo_train_step(cfg, make_optimizer(), beta=0.04, remat=True,
                                attn_impl=impl)
    batch, grid = video_packed_rows(cfg, device, 1)
    names = [n for n, _ in param_leaves(params)]

    def run():
        ref = step.ref_logps_fn(params, batch, grid_thw=grid,
                                num_generations=TRAIN_G)
        loss, _, grads = step.loss_and_grads(params, ref, batch,
                                             grid_thw=grid,
                                             num_generations=TRAIN_G)
        return float(loss), float(global_norm(grads)), names, grads

    return run


def vit_ring_model(cfg, device):
    from spacer_tpu_torch.models.qwen25_vl import init_params

    return init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)


def vit_ring_phase(device="cuda") -> dict:
    """Phase 16's world-1 paths over NCCL (torchrun's environment for rank
    0 of 1).  The ViT ring: phase 16's step (VIT_RING_* above) with
    attn_impl ("ring", create_mesh({"fsdp": 1}), "fsdp"), whose ViT
    full-attention blocks run K1 / K1-bwd at head_dim 80 over each whole
    frame chunk, against the same step without it (K4): loss within
    PP_LOSS_RTOL, every tensor's gradient cosine >= VIT_RING_COS_TOL, no K4
    launch in the ring run.  Then expert parallelism over data: phase 14's
    two Aria GRPO steps with moe_ep_axis "data" over create_mesh({"data": 1,
    "fsdp": 1, "tp": 1}), against the same over fsdp: bitwise (phase 12's
    gate), its ep exchanges counted and no more collectives issued than
    the fsdp run issues.  Returns the paths' launches."""
    import torch.distributed as dist

    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    t_phase = time.perf_counter()
    tp.set_mesh(None)
    world1_env()
    multihost.initialize(device=device)
    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=PP_LM_LAYERS))
    params = vit_ring_model(cfg, device)
    runs, problems = {}, []
    for kind, impl in (("K4", None),
                       ("ring", ("ring", create_mesh({"fsdp": 1}), "fsdp"))):
        run = vit_ring_step(cfg, device, params, impl)
        run()    # warm
        gc.collect()
        torch.cuda.empty_cache()
        _peak(device, reset=True)
        multihost.reset_collective_stats()
        reset_launch_counts()
        _sync(device)
        t = time.perf_counter()
        with IssuedCollectives() as issued:
            loss, norm, names, grads = run()
        _sync(device)
        runs[kind] = {"loss": loss, "grad_norm": norm, "grads": grads,
                      "s": time.perf_counter() - t, "peak": _peak(device),
                      "counts": launch_counts(), "issued": dict(issued.calls),
                      "collectives": multihost.collective_stats()}
        del run
    a, b = runs["K4"], runs["ring"]
    cos = {n: grad_cosine(x, y)
           for n, x, y in zip(names, b["grads"], a["grads"])}
    vit = [c for n, c in cos.items() if n.startswith("visual/")]
    log("phase 16 ViT ring vs K4: the lowest gradient cosines "
        + ", ".join(f"{n} {c:.6f}" for n, c in sorted(
            cos.items(), key=lambda x: x[1])[:4]) + " | "
        + small_grads_line(names, a["grads"], cos))
    for kind, r in runs.items():
        log(f"phase 16 ViT {kind}: loss {r['loss']!r} grad_norm "
            f"{r['grad_norm']!r} | loss and gradients {r['s']:.2f} s | "
            f"max_memory_allocated {gib(r['peak'])} | launches {r['counts']}"
            f" | collectives counted "
            + (_collective_line(r["collectives"], 1) or "none")
            + f", issued {r['issued'] or 'none'}")
    worst = min(cos.values())
    log(f"phase 16 ViT ring vs K4 at world 1: loss {b['loss']!r} vs "
        f"{a['loss']!r} (rel {abs(b['loss'] - a['loss']) / abs(a['loss']):.3e}"
        f", tol {PP_LOSS_RTOL:.0e}), grad_norm {b['grad_norm']!r} vs "
        f"{a['grad_norm']!r}, gradient cosine min {worst:.6f} over "
        f"{len(cos)} tensors (ViT's min {min(vit):.6f} over {len(vit)}; tol "
        f"{VIT_RING_COS_TOL})")
    if abs(b["loss"] - a["loss"]) > PP_LOSS_RTOL * abs(a["loss"]) or not (
            worst >= VIT_RING_COS_TOL):
        problems.append(f"ring vs K4: loss {b['loss']} vs {a['loss']}, "
                        f"cosine {worst}")
    if min(b["counts"][k] for k in VIT_RING_KERNELS) < 1 or b["counts"]["K4"]:
        problems.append(f"ring: launches {b['counts']} (K4 must not run)")
    if a["counts"]["K4"] < 1 or a["counts"]["K1 d80"]:
        problems.append(f"K4 path: launches {a['counts']}")
    if b["issued"]:
        problems.append(f"ring: issued {b['issued']} at world 1")
    paths = {"vit ring world 1": b["counts"]}
    del params, runs, a, b
    gc.collect()
    torch.cuda.empty_cache()

    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": 1})
    root = pathlib.Path(__file__).resolve().parent / "build"
    cfg_f = aria_ep_cfg()
    cfg_d = dataclasses.replace(cfg_f, text=dataclasses.replace(
        cfg_f.text, moe_ep_axis="data"))
    recs = {}
    for tag, c, ref in (("fsdp", cfg_f, None), ("data", cfg_d, "fsdp")):
        tp.set_mesh(None)
        with IssuedCollectives() as issued:
            recs[tag] = fsdp_train_run(
                c, str(root / f"smoke_ep16_{tag}"), mesh=mesh,
                ref=recs.get(ref), device=device, make=aria_ep_trainer)
        recs[tag]["issued"] = dict(issued.calls)
    problems += sharded_run_problems(recs["fsdp"], recs["data"],
                                     "ep over data vs over fsdp",
                                     EP_TRAIN_COLLECTIVES,
                                     ARIA_TRAIN_KERNELS + ("K1-bwd dq d72",
                                                           "K1-bwd dkv d72"))
    # the exchange over data is counted and not issued; the one collective
    # more is the gradient norm's sum over the experts' group, one an update
    want = collections.Counter(recs["fsdp"]["issued"])
    want["all_reduce"] += len(recs["data"]["steps"])
    log(f"phase 16 ep over data: issued {recs['data']['issued']} vs over "
        f"fsdp {recs['fsdp']['issued']} (one norm all_reduce an update "
        "more)")
    if collections.Counter(recs["data"]["issued"]) != want:
        problems.append("ep over data issued other collectives than over "
                        "fsdp at world 1")
    paths["aria ep over data world 1"] = recs["data"]["counts"]
    del recs
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    tp.set_mesh(None)
    shutil.rmtree(root / "smoke_aria", ignore_errors=True)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise RuntimeError("phase 16: " + "; ".join(problems))
    return paths


def spec_world_prompts(cfg):
    """SPEC_WORLD_PROMPTS text prompts of 256 random ids whose second half
    repeats the first (n-grams to draft from), the last left-padded by 40."""
    rng = np.random.default_rng(16)
    B, S = SPEC_WORLD_PROMPTS, 256
    ids = rng.integers(10, cfg.text.vocab_size, size=(B, S))
    ids[:, S // 2:] = ids[:, :S // 2]
    mask = np.ones((B, S), np.int64)
    ids[-1, :40], mask[-1, :40] = cfg.pad_token_id, 0
    pos = np.broadcast_to(np.maximum(np.cumsum(mask, 1) - 1, 0)[None],
                          (3, B, S)).copy()
    deltas = (pos[0].max(1, keepdims=True) + 1 - S).astype(np.int64)
    return ids, mask, pos, deltas


def _spec_world_run(rank, out, device="cuda", worlds=()):
    """A speculative rollout (SPEC_K drafts, greedy and at temperature 1)
    of spec_world_prompts at full 7B depth: one card alone (world 1), or
    over create_mesh({"data": N}) (the prompt rows split over the ranks)
    -> out/spec{N}.pt (tokens, stats, s per rollout).  At world 1 also,
    for each N of `worlds`, the greedy rollout of each of the N ranks'
    prompt slices alone, at that rank's row count (rec["slices"][N]: the
    slices' tokens in rank order, their stats summed)."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B, init_params
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.sampler import Sampler

    world = multihost.process_count()
    mesh = create_mesh({"data": world}) if world > 1 else None
    cfg = QWEN25_VL_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    ids, mask, pos, deltas = spec_world_prompts(cfg)
    sampler = Sampler(cfg, length_bucket=128, speculate_k=SPEC_K, mesh=mesh)

    def generate(sl, temp):
        return sampler.generate(
            ids[sl], mask[sl], params, position_ids=pos[:, sl],
            deltas=deltas[sl], num_generations=SPEC_WORLD_G,
            max_new_tokens=SPEC_WORLD_NEW_TOKENS, temperature=temp,
            top_p=0.95, seed=3)

    rec = {"slices": {}}
    for temp in (0.0, 1.0):
        _sync(device)
        t = time.perf_counter()
        res = generate(slice(None), temp)
        _sync(device)
        rec[temp] = {"tokens": res.sequences, "stats": res.stats,
                     "s": time.perf_counter() - t}
    for n in worlds:
        per = len(ids) // n
        got = [generate(slice(r * per, (r + 1) * per), 0.0)
               for r in range(n)]
        rec["slices"][n] = {
            "tokens": np.concatenate([g.sequences for g in got]),
            "stats": {k: sum(g.stats[k] for g in got)
                      for k in ("spec_row_steps", "spec_tokens")}}
    if rank == 0:
        torch.save(rec, out + f"/spec{world}.pt")


def _vit_world_reference(rank, out, device="cuda"):
    """--world's ViT references, on one card at full depth: phase 16's step
    without the ring (K4), warm and timed, and with the ring of one rank
    (K1 / K1-bwd over each whole chunk, the world-1 ring: the control that
    swaps the kernels and splits nothing) -> out/vit_ref.pt (loss,
    grad_norm, the selected gradients of both, the ring's cosines against
    K4, s and peak of the warm K4 step)."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel.mesh import create_mesh

    params = vit_ring_model(QWEN25_VL_7B, device)
    run = vit_ring_step(QWEN25_VL_7B, device, params)
    run()
    _peak(device, reset=True)
    _sync(device)
    t = time.perf_counter()
    loss, norm, names, grads = run()
    _sync(device)
    rec = {"loss": loss, "grad_norm": norm, "s": time.perf_counter() - t,
           "peak": _peak(device),
           "grads": {n: g.cpu() for n, g in zip(names, grads)
                     if _world_selected(n)}}
    del run, grads
    gc.collect()
    torch.cuda.empty_cache()
    run = vit_ring_step(QWEN25_VL_7B, device, params,
                        ("ring", create_mesh({"fsdp": 1}), "fsdp"))
    _, rec["ring1_grad_norm"], names, grads = run()
    rec["ring1"] = {n: g.cpu() for n, g in zip(names, grads)
                    if _world_selected(n)}
    rec["ring1_cos"] = {n: grad_cosine(g, rec["grads"][n])
                        for n, g in rec["ring1"].items()}
    torch.save(rec, out + "/vit_ref.pt")


def _vit_world_rank(rank, out, device="cuda"):
    """One rank of --world N's ViT ring: phase 16's step at full depth with
    the ring over create_mesh({"fsdp": N}) (the LM's and the ViT's), the
    first held against the references (cosines of the selected tensors
    against the K4 step and against the world-1 ring), the second timed
    (its peak and ring P2P) -> out/vit{N}.pt."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh

    world = multihost.process_count()
    mesh = create_mesh({"fsdp": world})
    params = vit_ring_model(QWEN25_VL_7B, device)
    run = vit_ring_step(QWEN25_VL_7B, device, params,
                        ("ring", mesh, "fsdp"))
    ref = torch.load(out + "/vit_ref.pt", weights_only=False)
    loss, norm, names, grads = run()
    rec = {"loss": loss, "grad_norm": norm, "cos": {}, "cos_ring1": {}}
    for n, g in zip(names, grads):
        if n in ref["grads"]:
            rec["cos"][n] = grad_cosine(g, ref["grads"][n].to(g.device))
            rec["cos_ring1"][n] = grad_cosine(g, ref["ring1"][n].to(g.device))
    del grads
    gc.collect()
    _peak(device, reset=True)
    multihost.reset_collective_stats()
    multihost.time_collectives(True)
    _sync(device)
    t = time.perf_counter()
    run()
    _sync(device)
    rec["s"] = time.perf_counter() - t
    multihost.time_collectives(False)
    rec["collectives"] = multihost.collective_stats()
    rec["peak"] = _peak(device)
    parts = multihost.all_gather_objects(rec)
    if rank == 0:
        torch.save(parts, out + f"/vit{world}.pt")


def phase16_world(worlds, device="cuda"):
    """`--phases 16 --world 2,4` (a development run): per N, Aria's GRPO
    step with the experts over data (N = 2: (2, 1, 1)) or over data x fsdp
    (N = 4: (2, 2, 1)) against one card (phase 14's --world gate); the
    speculative rollout over N cards' split rows against card 0 alone
    (token agreement, the acceptance counts, s); the ViT ring over N
    cards at full depth against one card's K4 step (phase 15's --world
    gates: loss, grad_norm, cosines; peak, s and ring P2P ms).  `--world
    1` runs the one-card references alone: the speculative rollout's
    whole batch and each rank's prompt slice of N = 2 and 4, and the ViT
    step's K4 path and its world-1 ring control (no ep: it needs ranks)."""
    out = str(pathlib.Path(__file__).resolve().parent / "build"
              / "smoke_world16")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    log("phase 16 world cards (nvidia-smi): " + " | ".join(
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True
                       ).stdout.strip().splitlines()[:max(worlds)]))
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    problems = (world16_ep(worlds, out, device)
                + world16_spec(worlds, out, device)
                + world16_vit(worlds, out, device))
    if problems:
        raise RuntimeError("phase 16 --world: " + "; ".join(problems))


def world16_ep(worlds, out, device="cuda") -> list:
    """--phases 16 --world's Aria steps with the experts over data
    (N = 2) or data x fsdp (N = 4) against one card -> problems."""
    from spacer_tpu_torch.parallel.multihost import launch_local

    problems = []
    if max(worlds) == 1:
        return problems
    t0 = time.perf_counter()
    launch_local(_world_reference, 1, args=(out, device, "aria"),
                 device=device, timeout=600)
    for world in worlds:
        kind, shape = EP_WORLD_AXES[world]
        launch_local(_world_rank, world, args=(out, device, shape, kind),
                     device=device, timeout=600)
        try:
            report_world_ranks(out, world, f"{kind} {shape}")
        except RuntimeError as e:
            problems.append(str(e))
    log(f"phase 16 --world ep: {time.perf_counter() - t0:.1f} s")
    return problems


def world16_spec(worlds, out, device="cuda") -> list:
    """--phases 16 --world's speculative rollouts over N cards' split
    rows against card 0 alone -> problems."""
    from spacer_tpu_torch.parallel.multihost import launch_local

    def agree(a, b) -> str:
        return (f"{float((a == b).mean()):.4f} (rows "
                f"{float((a == b).all(1).mean()):.3f})")

    problems = []
    t0 = time.perf_counter()
    launch_local(_spec_world_run, 1, args=(out, device, tuple(EP_WORLD_AXES)),
                 device=device, timeout=900)
    ref = torch.load(out + "/spec1.pt", weights_only=False)
    for n, sl in ref["slices"].items():
        log(f"speculative rollout on card 0, temperature 0.0: {n} prompt "
            f"slices run alone (each at one of {n} ranks' row counts) vs "
            f"the whole batch: tokens equal "
            f"{agree(sl['tokens'], ref[0.0]['tokens'])}, stats "
            f"{sl['stats']} vs {ref[0.0]['stats']}")
    for world in (w for w in worlds if w > 1):
        launch_local(_spec_world_run, world, args=(out, device),
                     device=device, timeout=600)
        got = torch.load(out + f"/spec{world}.pt", weights_only=False)
        for temp in (0.0, 1.0):
            a, b = got[temp], ref[temp]
            log(f"speculative rollout over ({world}, 1, 1), temperature "
                f"{temp}: tokens equal to card 0's whole batch "
                f"{agree(a['tokens'], b['tokens'])}, stats {a['stats']} vs "
                f"{b['stats']}, {a['s']:.2f} vs {b['s']:.2f} s")
            if a["tokens"].shape != b["tokens"].shape or not (
                    a["stats"]["spec_acceptance"] >= 1.0):
                problems.append(f"spec ({world}, 1, 1) temperature {temp}: "
                                f"{a['tokens'].shape} {a['stats']}")
        # greedy: each rank's rows are its prompt slice's rollout at its
        # row count, which card 0 runs alone slice by slice (the GEMMs see
        # the split's row counts): token for token
        a, sl = got[0.0], ref["slices"][world]
        same = bool(np.array_equal(a["tokens"], sl["tokens"]))
        log(f"speculative rollout over ({world}, 1, 1), temperature 0.0 vs "
            f"card 0 running each rank's slice alone: tokens equal "
            f"{agree(a['tokens'], sl['tokens'])}, bitwise {same}, stats "
            f"{sl['stats']}")
        if not same or any(a["stats"][k] != v for k, v in sl["stats"].items()):
            problems.append(f"spec ({world}, 1, 1) greedy: not the slices' "
                            f"tokens and counts alone")
    log(f"phase 16 --world speculative: {time.perf_counter() - t0:.1f} s")
    return problems


def world16_vit(worlds, out, device="cuda") -> list:
    """--phases 16 --world's ViT ring over N cards at full depth
    against one card's K4 step -> problems."""
    from spacer_tpu_torch.parallel.multihost import launch_local

    problems = []
    t0 = time.perf_counter()
    launch_local(_vit_world_reference, 1, args=(out, device), device=device,
                 timeout=600)
    vref = torch.load(out + "/vit_ref.pt", weights_only=False)
    ctrl = vref["ring1_cos"]
    names = list(vref["grads"])
    log(f"ViT step on one card at full depth, the world-1 ring (control) vs "
        f"K4: grad_norm {vref['ring1_grad_norm']!r} vs {vref['grad_norm']!r}"
        f", gradient cosine min {min(ctrl.values()):.6f} over {len(ctrl)} "
        "tensors (lowest: " + ", ".join(f"{n} {c:.6f}" for n, c in sorted(
            ctrl.items(), key=lambda x: x[1])[:4]) + ") | "
        + small_grads_line(names, [vref["grads"][n] for n in names], ctrl))
    for world in (w for w in worlds if w > 1):
        launch_local(_vit_world_rank, world, args=(out, device),
                     device=device, timeout=600)
        parts = torch.load(out + f"/vit{world}.pt", weights_only=False)
        for r, rec in enumerate(parts):
            log(f"ViT ring world {world} rank {r}: loss {rec['loss']!r} "
                f"grad_norm {rec['grad_norm']!r} | {rec['s']:.2f} s per step"
                f" | max_memory_allocated {gib(rec['peak'])} | per step: "
                + _collective_line(rec["collectives"], 1))
            if abs(rec["loss"] - vref["loss"]) > (PP_LOSS_RTOL
                                                  * abs(vref["loss"])):
                problems.append(f"ViT ring {world} rank {r}: loss "
                                f"{rec['loss']}")
            if abs(rec["grad_norm"] - vref["grad_norm"]) > (
                    PP_WORLD_NORM_RTOL * vref["grad_norm"]):
                problems.append(f"ViT ring {world} rank {r}: grad_norm "
                                f"{rec['grad_norm']}")
        problems += vit_world_gate(world, parts, vref)
    log(f"phase 16 --world ViT ring: {time.perf_counter() - t0:.1f} s")
    return problems


def vit_world_gate(world, parts, vref) -> list:
    """--world N's ViT gradient gate -> problems.  Every selected tensor's
    cosine against one card's K4 step must reach VIT_RING_COS_TOL, or, for
    a tensor below it, its deviation 1 - cosine may be at most
    VIT_RING_CTRL_FACTOR x N times the world-1 ring's (the control, run on
    one card at the same depth: it swaps K4 for K1 and splits nothing).
    The ring rounds each of its N blocks' outputs and dq / dk / dv partials
    to bf16 before it merges them, so a gradient whose sum cancels (the
    SMALL_GRAD tensors) drifts further from one card's as N grows; the
    factor is set from the readings in PERF.md section 6.  Also logged:
    the cosines against the world-1 ring (the split alone) and the
    SMALL_GRAD tensors' norms."""
    cos, cos1 = {}, {}
    for rec in parts:
        cos.update(rec["cos"])
        cos1.update(rec["cos_ring1"])
    ctrl = vref["ring1_cos"]
    names = list(vref["grads"])
    below = {n: c for n, c in cos.items() if not c >= VIT_RING_COS_TOL}
    factor = VIT_RING_CTRL_FACTOR * world
    failed = {n: c for n, c in below.items()
              if not 1 - c <= factor * (1 - ctrl[n])}
    worst = min(cos.values())
    log(f"ViT ring world {world} vs 1 card's K4 step: loss "
        f"{parts[0]['loss']!r} vs {vref['loss']!r}, grad_norm "
        f"{parts[0]['grad_norm']!r} vs {vref['grad_norm']!r} (world-1 ring "
        f"{vref['ring1_grad_norm']!r}), gradient cosine min {worst:.6f} over "
        f"{len(cos)} of {len(names)} tensors (lowest: " + ", ".join(
            f"{n} {c:.6f} (control {ctrl[n]:.6f})" for n, c in sorted(
                cos.items(), key=lambda x: x[1])[:4])
        + f"); {len(below)} below {VIT_RING_COS_TOL}, {len(failed)} of them "
        f"beyond {factor} x the control's deviation | control (world-1 "
        f"ring vs K4) min {min(ctrl.values()):.6f} | vs the world-1 ring (the"
        f" split alone) min {min(cos1.values()):.6f} | "
        + small_grads_line(names, [vref["grads"][n] for n in names], cos)
        + f" | 1 card: {vref['s']:.2f} s, max_memory_allocated "
        f"{gib(vref['peak'])}")
    if len(cos) != len(names) or failed:
        return [f"ViT ring {world}: {len(cos)} of {len(names)} tensors, "
                f"beyond the gate: {failed}"]
    return []


# Phase 18, the entry points the port gained last.  (a) forward and
# make_kv_cache at full Qwen2.5-VL-7B geometry: serving_setup's first video
# and first text request, API_DECODE_STEPS greedy steps, the cached steps
# held against a no-cache forward at API_CHECK_STEPS.  (b) - (f) at
# Qwen2.5-VL-7B widths with the LM cut to PP_LM_LAYERS: the non-causal LM
# on API_ROWS rows of API_SEQ tokens, API_PAD pad keys in the second;
# lm_decode_step at TRAIN_G completions of API_ROWS prompts of
# TRAIN_PROMPT_BUCKET keys; window_attention at API_WINDOW_SHAPE, every
# third window API_WINDOW_LIVE tokens; load_model_only at phase 6's
# CKPT_LM_LAYERS; the LoRA step on phase 15's packed rows.
API_DECODE_STEPS, API_CHECK_STEPS = 32, (1, 16, 32)
API_ROWS, API_SEQ, API_PAD = 2, 1536, 300
API_DECODE_TAIL, API_DECODE_INDEX = 64, 40
API_WINDOW_SHAPE, API_WINDOW_WT, API_WINDOW_LIVE = (4096, 16, 80), 64, 40
API_FORWARD_KERNELS = ("K1", "K3", "K4")
API_NONCAUSAL_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv")
API_DECODE_KERNELS = ("K2", "K2-int8")
API_LORA_KERNELS = ("K1", "K1-bwd dq", "K1-bwd dkv")


def _cos_rows(a, b) -> float:
    """The least cosine over the rows (last dim) of two logits tensors."""
    return float(torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=-1).min())


def api_forward_run(device="cuda") -> dict:
    """Phase 18a: models.qwen25_vl.forward at full Qwen2.5-VL-7B geometry
    (random bf16 weights, seed 0) on one 16-frame 360x640 video prompt and
    one text prompt: a prefill into make_kv_cache(cfg, 2, P +
    API_DECODE_STEPS) bitwise encode_vision + merge_vision_embeds +
    lm_forward on the same inputs (logits and cache), then
    API_DECODE_STEPS greedy steps through forward(cache=, cache_index=),
    the last position's logits at API_CHECK_STEPS at cosine >=
    SLICE_COS_TOL against a no-cache forward over the sequence so far.
    K1, K3 and K4 must launch.  -> the path's launches."""
    from spacer_tpu_torch.models.qwen25_vl import (
        QWEN25_VL_7B,
        encode_vision,
        forward,
        make_kv_cache,
        merge_vision_embeds,
    )
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.models.registry import encode_batch
    from spacer_tpu_torch.nn.core import embed
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = QWEN25_VL_7B
    params, proc, msgs = serving_setup(cfg, device)
    req = encode_batch(proc, cfg, [msgs[0], msgs[1]])

    def t(x, dtype=torch.long):
        return torch.as_tensor(x, device=device).to(dtype)

    ids, mask = t(req["input_ids"]), t(req["attention_mask"], torch.bool)
    pos = t(req["position_ids"])
    deltas = t(req["deltas"]).reshape(-1)
    # in the params' dtype, as the serving path ships them
    px = torch.as_tensor(req["vision_kwargs"]["pixel_values"],
                         device=device).to(torch.bfloat16)
    grid = req["grid_thw"]
    B, P = ids.shape
    T = P + API_DECODE_STEPS
    kv = torch.zeros((B, T), dtype=torch.bool, device=device)
    kv[:, :P] = mask
    steps_ms, checked, tokens = [], {}, []
    problems = []
    reset_launch_counts()
    with torch.no_grad():
        cache = make_kv_cache(cfg, B, T, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = forward(params, cfg, ids, pixel_values=px,
                                grid_thw=grid, position_ids=pos,
                                kv_mask=kv, cache=cache, cache_index=0)
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        nxt = logits[:, -1].argmax(-1)
        for i in range(API_DECODE_STEPS):
            at = P + i
            kv[:, at] = True
            p = (deltas + at).view(1, B, 1).expand(3, B, 1)
            tokens.append(nxt)
            _sync(device)
            t0 = time.perf_counter()
            lg, cache = forward(params, cfg, nxt[:, None], position_ids=p,
                                kv_mask=kv, cache=cache, cache_index=at)
            _sync(device)
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            if i + 1 in API_CHECK_STEPS:
                checked[i + 1] = lg[:, -1].float()
            nxt = lg[:, -1].argmax(-1)
    counts = launch_counts()
    with torch.no_grad():
        # the same prefill as the serving path composes it
        ve = encode_vision(params, cfg, px, grid)
        emb = merge_vision_embeds(cfg, ids, embed(
            params["model"]["embed_tokens"], ids), ve)
        kv0 = torch.zeros_like(kv)
        kv0[:, :P] = mask
        ref, ref_cache = lm_forward(
            params["model"], cfg.text, input_embeds=emb, position_ids=pos,
            kv_mask=kv0, cache=make_kv_cache(cfg, B, T, device=device),
            cache_index=0)
        same = torch.equal(logits, ref)
        del ref, emb, ve
        # the prefill's keys and values: the cache positions it wrote
        same_cache = all(torch.equal(a[:, :P], b[:, :P])
                         for name in ("k", "v")
                         for a, b in zip(cache[name], ref_cache[name]))
        del ref_cache, logits
        cos = {}
        seq = torch.stack(tokens, dim=1)
        for s in API_CHECK_STEPS:
            full_ids = torch.cat([ids, seq[:, :s]], dim=1)
            full_pos = torch.cat([pos, (deltas[:, None] + P + torch.arange(
                s, device=device)[None]).expand(3, B, s)], dim=2)
            full_mask = torch.cat([mask, torch.ones((B, s), dtype=torch.bool,
                                                    device=device)], dim=1)
            want, _ = forward(params, cfg, full_ids, pixel_values=px,
                              grid_thw=grid, position_ids=full_pos,
                              kv_mask=full_mask)
            cos[s] = _cos_rows(checked[s], want[:, -1])
            del want
    log(f"phase 18a forward: prompt {P} tokens x {B} rows (vision grid "
        f"{grid}), prefill {prefill_ms:.1f} ms, {API_DECODE_STEPS} cached "
        f"steps at {statistics.median(steps_ms):.2f} ms a step (median; "
        f"min {min(steps_ms):.2f}, max {max(steps_ms):.2f}) | prefill "
        f"bitwise the composition: logits {same}, cache {same_cache} | "
        f"cached step vs no-cache forward, last-position logits cosine "
        + ", ".join(f"step {s} {c:.6f}" for s, c in cos.items())
        + f" (tol {SLICE_COS_TOL}) | launches {counts}")
    if not (same and same_cache):
        problems.append("forward's prefill is not bitwise the composition")
    if not all(c >= SLICE_COS_TOL for c in cos.values()):
        problems.append(f"cached steps off the no-cache forward: {cos}")
    if min(counts[k] for k in API_FORWARD_KERNELS) < 1:
        problems.append(f"a kernel of forward's path never launched: {counts}")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise RuntimeError("phase 18a: " + "; ".join(problems))
    return counts


def noncausal_rows(cfg, device):
    """API_ROWS rows of API_SEQ random tokens, the second left-padded by
    API_PAD (ids, kv_mask, positions)."""
    gen = torch.Generator(device=device).manual_seed(18)
    ids = torch.randint(10, cfg.text.vocab_size, (API_ROWS, API_SEQ),
                        generator=gen, device=device)
    mask = torch.ones((API_ROWS, API_SEQ), dtype=torch.bool, device=device)
    mask[1, :API_PAD] = False
    ids[~mask] = cfg.pad_token_id
    pos = (mask.cumsum(1) - 1).clamp_min(0)[None].expand(3, -1, -1)
    return ids, mask, pos.contiguous()


def check_noncausal_kernels(device="cuda") -> dict:
    """Phase 18b's kernels: K1 and K1-bwd (dq, dk/dv) at causal=0 on the
    LM's heads (28 q, 4 KV heads of 128) at API_ROWS x API_SEQ with
    API_PAD pad keys in the second row, against their plain versions, with
    torch's SDPA (the key mask as its bias) and its masked backward as the
    library calls."""
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(181)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    B, S, H, Hkv, D = API_ROWS, API_SEQ, 28, 4, 128
    mask = torch.ones((B, S), dtype=torch.bool, device=device)
    mask[1, :API_PAD] = False
    q, k, v, dout = randn(B, S, H, D), randn(B, S, Hkv, D),         randn(B, S, Hkv, D), randn(B, S, H, D)
    kw = dict(causal=False, kv_mask=mask)
    keys = int(mask.sum())            # the live keys, over the rows
    pairs = S * keys                  # every query row sees its row's keys
    sdpa_mask = mask[:, None, None, :].expand(B, 1, S, S)
    q_rows = B * S
    tag = f"causal=0 B={B} S={S} pad {API_PAD}"
    results = {"K1": compare(
        f"K1 flash_attention [{tag}]",
        lambda: fa.flash_attention(q, k, v, **kw),
        lambda: xla_attention(q, k, v, **kw),
        work=(q_rows * H * D * 2 * 2 + keys * Hkv * D * 2 * 2
              + q_rows * H * 4, 4 * D * H * pairs),
        library_fn=lambda: sdpa_masked(q, k, v, sdpa_mask))}
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout)
    library = bwd_yardstick(q, k, v, dout, out, lse, False, sdpa_mask)
    q_bytes = q_rows * (H * D * 2 + H * 4)
    results["K1-bwd dq"] = compare(
        f"K1-bwd dq [{tag}]", lambda: fa.flash_attention_bwd_dq(*args, **kw),
        lambda: fa.attention_bwd_reference(q, k, v, dout, **kw)[0],
        rel_norm=True, library_fn=library,
        work=(q_bytes + q_rows * H * D * 2 * 3 + keys * Hkv * D * 2 * 2,
              6 * D * H * pairs))
    log(f"K1-bwd dk/dv [{tag}]: splits {fa.dkv_split_count(q, k)}")
    results["K1-bwd dkv"] = compare(
        f"K1-bwd dk/dv [{tag}]",
        lambda: fa.flash_attention_bwd_dkv(*args, **kw),
        lambda: fa.attention_bwd_reference(q, k, v, dout, **kw)[1:],
        rel_norm=True, library_fn=library,
        work=(q_bytes + q_rows * H * D * 2 * 2 + keys * Hkv * D * 2 * 4,
              8 * D * H * pairs))
    return results


def api_noncausal_run(cfg, device, mesh) -> dict:
    """Phase 18b: lm_forward(causal=False) at cfg's widths on
    noncausal_rows, forward and backward of a loss over the live rows,
    through the kernels and through their plain versions (logits cosine
    per row and every gradient's cosine >= GRAD_COS_TOL), and the same
    through pipeline_lm_forward(causal=False) over `mesh` (pipe 1, M = 1):
    bitwise the kernel step.  -> the kernel step's launches."""
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.parallel.pipeline import pipeline_lm_forward
    from spacer_tpu_torch.train.step import param_leaves

    model = pp_model(cfg, device)["model"]
    named = param_leaves(model)
    leaves = [t for _, t in named]
    for x in leaves:
        x.requires_grad_(True)
    ids, mask, pos = noncausal_rows(cfg, device)
    kw = dict(input_ids=ids, position_ids=pos, kv_mask=mask, causal=False,
              remat=True)

    def run(fn):
        logits = fn()
        loss = logits.float()[mask].square().mean()
        return logits.detach(), torch.autograd.grad(loss, leaves)

    reset_launch_counts()
    logits, grads = run(lambda: lm_forward(model, cfg.text, **kw)[0])
    counts = launch_counts()
    with plain_kernels():
        plain, pgrads = run(lambda: lm_forward(model, cfg.text, **kw)[0])
    lcos = _cos_rows(logits[mask], plain[mask])
    del plain
    gcos = {n: grad_cosine(a, b) for (n, _), a, b in zip(named, grads,
                                                         pgrads)}
    del pgrads
    pipe, pp_grads = run(lambda: pipeline_lm_forward(
        model, cfg.text, mesh, num_microbatches=1, **kw))
    same = torch.equal(pipe, logits) and all(
        torch.equal(a, b) for a, b in zip(grads, pp_grads))
    worst = min(gcos, key=gcos.get)
    log(f"phase 18b non-causal LM ({cfg.text.num_layers} layers, "
        f"{API_ROWS} x {API_SEQ}, pad {API_PAD}), kernels vs plain "
        f"attention: logits cosine min {lcos:.6f} over the live rows, "
        f"gradient cosine min {gcos[worst]:.6f} ({worst}) over {len(gcos)} "
        f"tensors (tol {GRAD_COS_TOL}) | pipeline (pipe 1, M 1) bitwise the "
        f"kernel step: {same} | launches {counts}")
    problems = []
    if not (lcos >= GRAD_COS_TOL and gcos[worst] >= GRAD_COS_TOL):
        problems.append(f"kernels vs plain: logits {lcos}, {worst} "
                        f"{gcos[worst]}")
    if not same:
        problems.append("the pipeline is not bitwise the plain step")
    if min(counts[k] for k in API_NONCAUSAL_KERNELS) < 1:
        problems.append(f"a kernel never launched: {counts}")
    del model, leaves, named, grads, pp_grads, pipe, logits
    gc.collect()
    if problems:
        raise RuntimeError("phase 18b: " + "; ".join(problems))
    return counts


def api_decode_run(cfg, device) -> dict:
    """Phase 18c: lm_decode_step over stacked position-major caches
    against lm_decode_step_split on head-major copies of the same buffers,
    bf16 and int8 caches (quantize_kv): logits and the new tail bitwise.
    -> the launches of the two lm_decode_step calls."""
    from spacer_tpu_torch.models.qwen25_vl.language import (
        lm_decode_step,
        lm_decode_step_split,
    )
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.ops.flash_decode import MASK_VALUE
    from spacer_tpu_torch.ops.quant import quantize_kv

    model = pp_model(cfg, device)["model"]
    tc = cfg.text
    L, Hkv, Dh = tc.num_layers, tc.num_kv_heads, tc.head_dim
    B, G, P, T, ti = API_ROWS, TRAIN_G, TRAIN_PROMPT_BUCKET,         API_DECODE_TAIL, API_DECODE_INDEX
    N = B * G
    gen = torch.Generator(device=device).manual_seed(182)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    prefix = {n: [randn(B, P, Hkv, Dh) for _ in range(L)] for n in "kv"}
    tail = {n: [randn(N, T, Hkv, Dh) for _ in range(L)] for n in "kv"}
    pmask = torch.ones((B, P), dtype=torch.bool, device=device)
    pmask[1, :TRAIN_PROMPT_PAD] = False
    tmask = (torch.arange(T, device=device) <= ti)[None].expand(N, T)
    ids = torch.randint(10, tc.vocab_size, (N, 1), generator=gen,
                        device=device)
    pos = (P + ti + torch.arange(N, device=device)).view(1, N, 1).expand(
        3, N, 1)
    bias_p = torch.where(pmask, 0.0, MASK_VALUE)[:, None, :].float()

    def quant(cache):
        out = {"k": [], "v": [], "k_scale": [], "v_scale": []}
        for n in "kv":
            for x in cache[n]:
                q, sc = quantize_kv(x)
                out[n].append(q)
                out[f"{n}_scale"].append(sc)
        return out

    def head_major(cache):
        names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache \
            else ("k", "v")
        return [tuple(cache[n][l].transpose(1, 2).contiguous()
                      for n in names) for l in range(L)]

    counts, problems = collections.Counter(), []
    for kind, pre, tl in (("bf16", prefix, tail),
                          ("int8", quant(prefix), quant(tail))):
        with torch.no_grad():
            reset_launch_counts()
            logits, new = lm_decode_step(model, tc, ids, pos, pre, pmask, tl,
                                         tmask, ti, G)
            counts.update(launch_counts())
            tails = head_major(tl)
            want = lm_decode_step_split(model["layers"], model, tc, ids, pos,
                                        head_major(pre), bias_p.contiguous(),
                                        tails, tail_index=ti, group=G,
                                        tail_len=ti + 1)
        same = torch.equal(logits, want) and all(
            torch.equal(new[n][l], tails[l][i].transpose(1, 2))
            for i, n in enumerate(new) for l in range(L))
        log(f"phase 18c lm_decode_step [{kind}] ({L} layers, B {B}, G {G}, "
            f"P {P}, tail index {ti}): logits and new tail bitwise "
            f"lm_decode_step_split: {same}, finite "
            f"{bool(torch.isfinite(logits).all())}")
        if not same or not bool(torch.isfinite(logits).all()):
            problems.append(f"{kind}: lm_decode_step differs from the split "
                            "step")
    counts = {k: counts.get(k, 0) for k in SOURCES}
    if min(counts[k] for k in API_DECODE_KERNELS) < 1:
        problems.append(f"a kernel never launched: {counts}")
    del model, prefix, tail
    gc.collect()
    if problems:
        raise RuntimeError("phase 18c: " + "; ".join(problems))
    return counts


def api_window_run(device) -> dict:
    """Phase 18d: window_attention on K3 at API_WINDOW_SHAPE, windows of
    API_WINDOW_WT with every third one API_WINDOW_LIVE tokens long: the
    forward within BF16_TOL (1 + |plain|) of the plain version (K3's gate),
    the gradients of q, k and v within GRAD_REL_TOL rel-norm of an f32
    masked softmax over the windows (JAX's `_xla_reference` form).  K3 has
    no backward kernel: the gradients are the plain recompute by design, so
    that gate holds the layout and the bias, not a kernel.  -> launches."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.ops.vit_window_attention import window_attention

    S, H, D = API_WINDOW_SHAPE
    wt = API_WINDOW_WT
    lengths = [API_WINDOW_LIVE if i % 3 == 0 else wt for i in range(S // wt)]
    gen = torch.Generator(device=device).manual_seed(183)
    q, k, v, w = (torch.randn((S, H, D), generator=gen, device=device).to(
        torch.bfloat16) for _ in range(4))

    def run():
        qd, kd, vd = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = window_attention(qd, kd, vd, lengths, wt=wt)
        grads = torch.autograd.grad((out.float() * w.float()).sum(),
                                    (qd, kd, vd))
        return out.detach(), grads

    def f32_grads():
        n = S // wt
        valid = (torch.arange(wt, device=device)[None]
                 < torch.tensor(lengths, device=device)[:, None])
        qf, kf, vf = (x.detach().float().requires_grad_(True)
                      for x in (q, k, v))
        s = torch.einsum("nihd,njhd->nhij", *(x.reshape(n, wt, H, D)
                                              for x in (qf, kf))) * D ** -0.5
        p = torch.softmax(s.masked_fill(~valid[:, None, None], float("-inf")),
                          dim=-1)
        o = torch.einsum("nhij,njhd->nihd", p, vf.reshape(n, wt, H, D))
        return torch.autograd.grad((o.reshape(S, H, D) * w.float()).sum(),
                                   (qf, kf, vf))

    reset_launch_counts()
    out, grads = run()
    counts = launch_counts()
    rgrads = f32_grads()
    with plain_kernels():
        ref, _ = run()
        plain_ms = median_ms(lambda: window_attention(q, k, v, lengths,
                                                      wt=wt))
    ms = median_ms(lambda: window_attention(q, k, v, lengths, wt=wt))
    err = float((out.float() - ref.float()).abs().max())
    within = bool(((out.float() - ref.float()).abs()
                   <= BF16_TOL * (1 + ref.float().abs())).all())
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(grads, rgrads)]
    log(f"phase 18d window_attention {tuple(API_WINDOW_SHAPE)} wt {wt}, "
        f"{lengths.count(API_WINDOW_LIVE)} of {len(lengths)} windows "
        f"{API_WINDOW_LIVE} long: forward max_abs_err {err:.3e} (tol "
        f"{BF16_TOL:.0e} * (1 + |ref|)), gradients rel-norm to f32 "
        f"{', '.join(f'{x:.3e}' for x in rel)} (tol {GRAD_REL_TOL:.0e}) | "
        f"forward {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, "
        f"the layout copies included) | launches "
        f"{counts}")
    if not within or max(rel) > GRAD_REL_TOL or counts["K3"] < 1:
        raise RuntimeError(f"phase 18d: window_attention err {err}, grads "
                           f"{rel}, launches {counts}")
    return counts


def api_checkpoint_run(device) -> None:
    """Phase 18e: save_model_only then load_model_only(params_like=) at
    Qwen2.5-VL-7B widths with the LM cut to CKPT_LM_LAYERS, under build/:
    every tensor bitwise; save and load GB/s (the load reads files just
    written: mostly the page cache)."""
    import tempfile

    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B, init_params
    from spacer_tpu_torch.train.checkpoint import (
        load_model_only,
        save_model_only,
    )

    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=CKPT_LM_LAYERS))
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_model_only_", dir=root)
    try:
        _sync(device)
        t0 = time.perf_counter()
        path = save_model_only(os.path.join(tmp, "model"), params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_model_only(path, params_like=params)
        _sync(device)
        load_s = time.perf_counter() - t0
        bad = _tree_diff(params, loaded)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 18e save_model_only / load_model_only: {n_bytes / 1e9:.3f} "
        f"GB (LM {CKPT_LM_LAYERS} layers), save {save_s:.2f} s "
        f"({n_bytes / save_s / 1e9:.3f} GB/s), load onto the card "
        f"{load_s:.2f} s ({n_bytes / load_s / 1e9:.3f} GB/s; warm: the "
        f"file was just written) | {bad} tensors differ")
    del params, loaded
    gc.collect()
    if bad:
        raise RuntimeError(f"phase 18e: {bad} tensors differ after the "
                           "round trip")


def api_lora_run(cfg, device, mesh) -> dict:
    """Phase 18f: one LoRA GRPO step (make_lora_grpo_train_step, r 8, b
    drawn nonzero so both adapters move) on phase 15's packed rows, plain
    and with attn_impl ("ring", mesh, "fsdp") at world 1: loss, kl,
    grad_norm and the adapters after the step bitwise.  -> the ring step's
    launches."""
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.train.lora import (
        LoraConfig,
        init_lora_params,
        lora_leaves,
        make_lora_grpo_train_step,
    )
    from spacer_tpu_torch.train.optimizer import make_optimizer

    base = pp_model(cfg, device)
    batch = packed_rows(cfg, device, 1)
    lcfg = LoraConfig(r=8)
    runs = {}
    for name, impl in (("plain", None), ("ring", ("ring", mesh, "fsdp"))):
        gen = torch.Generator(device=device).manual_seed(184)
        lora = init_lora_params(gen, base, lcfg)
        for ab in lora.values():
            ab["b"].normal_(0.0, 0.02, generator=gen)
        tx = make_optimizer(learning_rate=1e-4, total_steps=10,
                            moment_dtype="float32")
        leaves = lora_leaves(lora)
        state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
        step = make_lora_grpo_train_step(cfg, tx, lcfg, beta=0.04,
                                         remat=True, attn_impl=impl)
        reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        lora, _, m = step(base, lora, state, batch, num_generations=TRAIN_G)
        _sync(device)
        runs[name] = dict(
            metrics={k: float(m[k]) for k in ("loss", "kl", "grad_norm")},
            lora=[t.detach() for _, t in lora_leaves(lora)],
            s=time.perf_counter() - t0, counts=launch_counts())
    plain, ring = runs["plain"], runs["ring"]
    same = plain["metrics"] == ring["metrics"] and all(
        torch.equal(a, b) for a, b in zip(plain["lora"], ring["lora"]))
    log(f"phase 18f LoRA GRPO step: plain {plain['metrics']} "
        f"{plain['s']:.2f} s | ring (world 1) {ring['metrics']} "
        f"{ring['s']:.2f} s | bitwise: {same} over {len(ring['lora'])} "
        f"adapter tensors | launches {ring['counts']}")
    counts, problems = ring["counts"], []
    if not same:
        problems.append("the ring LoRA step is not bitwise the plain one")
    if min(counts[k] for k in API_LORA_KERNELS) < 1:
        problems.append(f"a kernel never launched: {counts}")
    del base, runs, plain, ring
    gc.collect()
    if problems:
        raise RuntimeError("phase 18f: " + "; ".join(problems))
    return counts


def api_phase(device="cuda") -> dict:
    """Phase 18: 18a (api_forward_run) at full geometry, then at
    Qwen2.5-VL-7B widths with the LM cut to PP_LM_LAYERS the kernels at
    causal=0 (check_noncausal_kernels) and 18b-18f, the pipeline and the
    ring at world 1 over NCCL (torchrun's environment for rank 0 of 1).
    Every sub-phase runs; the phase fails after them if any failed.
    -> each path's launches."""
    import torch.distributed as dist

    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    paths, failed = {}, []

    def sub(name, fn, *a):
        try:
            out = fn(*a)
        except Exception as e:   # noqa: BLE001 (re-raised below)
            log(f"phase 18: {name} FAILED: {type(e).__name__}: {e}")
            failed.append(name)
            out = None
        gc.collect()
        torch.cuda.empty_cache()
        return out

    paths["api forward (prefill + cached steps)"] = sub(
        "18a", api_forward_run, device)
    tp.set_mesh(None)
    world1_env()
    multihost.initialize(device=device)
    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=PP_LM_LAYERS))
    sub("18b kernels", check_noncausal_kernels, device)
    paths["api non-causal LM"] = sub("18b", api_noncausal_run, cfg, device,
                                     create_mesh({"pipe": 1}))
    paths["api lm_decode_step"] = sub("18c", api_decode_run, cfg, device)
    paths["api window_attention"] = sub("18d", api_window_run, device)
    sub("18e", api_checkpoint_run, device)
    paths["api lora ring world 1"] = sub("18f", api_lora_run, cfg, device,
                                         create_mesh({"fsdp": 1}))
    dist.destroy_process_group()
    if failed:
        raise RuntimeError(f"phase 18: {failed} failed")
    return paths


def cli_main(mode: str, argv):
    """`chip_smoke.py --cli-step ARGS` / `--cli-serve ARGS` (torchrun_self's
    targets): spacer_tpu_torch.cli.train_sg_rlvr.main(ARGS) /
    spacer_tpu_torch.cli.serve.main(ARGS) with every kernel call sent to
    its plain version."""
    from spacer_tpu_torch.cli import serve, train_sg_rlvr
    from spacer_tpu_torch.utils.debugging import interpret_kernels

    entry = {"--cli-step": train_sg_rlvr, "--cli-serve": serve}[mode]
    with interpret_kernels() as calls:
        entry.main(argv)
    log(f"cli {mode[6:]}: kernel calls sent to their plain versions: "
        f"{dict(calls)}")
    return 0


def main(argv=None):
    """Every phase (no arguments, as the contract runs it), or with
    `--phases 3,4c,10` the device facts, the build and those phases only,
    a development run that prints no kernels line and no result line
    (4c / 4d run on phase 4's params, 5c after phase 5).  `--phases 12
    --world N` runs phase 12's N-card variant instead (fsdp_world_phase),
    `--phases 13 --world N[,M]` phase 13's (tp_world_phase), `--phases 14
    --world N[,M]` phase 14's (aria_world_phase), `--phases 15 --world
    N[,M]` phase 15's (ring_pipe_world_phase), `--phases 16 --world 2[,4]`
    phase 16's (phase16_world), `--phases 17 --world N[,M]` phase 17's
    (ring_pipe_world_phase for Aria)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] in (["--cli-step"], ["--cli-serve"]):
        return cli_main(argv[0], argv[1:])
    phases, world = PHASES, None
    if argv:
        usage = "usage: chip_smoke.py [--phases 3,4,4c,... [--world N]]"
        if len(argv) not in (2, 4) or argv[0] != "--phases":
            raise SystemExit(usage)
        phases = tuple(argv[1].split(","))
        unknown = set(phases) - set(PHASES)
        if unknown or ("5c" in phases and "5" not in phases):
            raise SystemExit(f"phases {sorted(unknown)} unknown, or 5c "
                             f"without 5; known: {PHASES}")
        if len(argv) == 4:
            if argv[2] != "--world" or phases not in (
                    ("12",), ("13",), ("14",), ("15",), ("16",), ("17",)):
                raise SystemExit(usage + " (--world with --phases 12, 13, "
                                 "14, 15, 16 or 17 only)")
            world = [int(w) for w in argv[3].split(",")]
            if phases == ("12",) and len(world) != 1:
                raise SystemExit("--phases 12 takes one --world")
            if phases == ("16",) and not (world == [1] or set(world) <= set(
                    EP_WORLD_AXES)):
                raise SystemExit("--phases 16 takes --world 2 and / or 4, "
                                 "or 1 (the references alone)")
            if not all(1 <= w <= torch.cuda.device_count() for w in world):
                raise SystemExit(f"--world {argv[3]}: "
                                 f"{torch.cuda.device_count()} cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_main, seconds = time.perf_counter(), time_phases(globals())
    smi = device_facts()
    build_kernels()
    if world is not None:
        if phases == ("12",):
            fsdp_world_phase(world[0])
        elif phases == ("13",):
            tp_world_phase(world)
        elif phases == ("14",):
            aria_world_phase(world)
        elif phases == ("15",):
            ring_pipe_world_phase(world)
        elif phases == ("17",):
            ring_pipe_world_phase(world, model="aria")
        else:
            phase16_world(world)
        log(f"development run of phase {phases[0]} at world {world}: no "
            "kernels line, no result")
        return 0
    results = {}
    if "3" in phases:
        results.update(check_kernels())
        results.update(check_training_kernels())
        results.update(check_aria_kernels())
    if "3d" in phases:
        check_tp_kernels()
    if "3e" in phases:
        check_aria_tp_kernels()
    if "3f" in phases:
        check_ring_kernels()
        gc.collect()
        torch.cuda.empty_cache()
        check_ring_kernels(heads=RING_ARIA_HEADS, tag=" (Aria LM heads)")
        gc.collect()
        torch.cuda.empty_cache()
    if "16" in phases:
        results.update(check_vit_ring_kernels())
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    paths = {}
    if {"4", "4c", "4d"} & set(phases):
        paths.update(serve_slice(QWEN25_VL_7B, phases=phases))
        gc.collect()
        torch.cuda.empty_cache()
    if "5" in phases:
        train_cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
            QWEN25_VL_7B.text, num_layers=TRAIN_LM_LAYERS))
        paths.update(train_slice(train_cfg, phases=phases))
        gc.collect()
        torch.cuda.empty_cache()
    if "6" in phases:
        checkpoint_phase()
        gc.collect()
        torch.cuda.empty_cache()
    if "7" in phases:
        paths.update(eval_slice(QWEN25_VL_7B))
        gc.collect()
        torch.cuda.empty_cache()
    if "8" in phases:
        counts, first, trainer = full_train_slice(QWEN25_VL_7B)
        paths["train full depth"] = counts
        paths["lora full depth"] = lora_phase(trainer, first)
        del trainer, first
        gc.collect()
        torch.cuda.empty_cache()
    if "9" in phases:
        paths["sft full depth"] = sft_phase(QWEN25_VL_7B)
        gc.collect()
        torch.cuda.empty_cache()
    if "10" in phases:
        paths["qwen2-vl serve"] = qwen2_vl_phase()
        gc.collect()
        torch.cuda.empty_cache()
    if "11" in phases:
        paths.update(aria_serve_phase())
        gc.collect()
        torch.cuda.empty_cache()
        paths["aria train"] = aria_train_phase()
        gc.collect()
        torch.cuda.empty_cache()
    if "12" in phases:
        paths["train fsdp world 1"] = fsdp_phase()
        gc.collect()
        torch.cuda.empty_cache()
    if "13" in phases:
        paths.update(tp_phase())
        gc.collect()
        torch.cuda.empty_cache()
    if "14" in phases:
        paths.update(aria_ep_phase())
        gc.collect()
        torch.cuda.empty_cache()
    if "15" in phases:
        paths.update(ring_pipe_phase())
        gc.collect()
        torch.cuda.empty_cache()
    if "16" in phases:
        paths.update(vit_ring_phase())
        gc.collect()
        torch.cuda.empty_cache()
    if "17" in phases:
        paths.update(aria_ring_pipe_phase())
        gc.collect()
        torch.cuda.empty_cache()
    if "18" in phases:
        paths.update(api_phase())
    counts = {k: sum(c.get(k, 0) for c in paths.values()) for k in SOURCES}
    log("launches per path: " + json.dumps(paths))
    log(phase_seconds_line(seconds, time.perf_counter() - t_main))
    if phases != PHASES:
        log(f"development run of phases {list(phases)}: no kernels line, "
            "no result")
        return 0
    kernels = [{"name": SOURCES[k][0], "route": "cuda", "source": SOURCES[k][1],
                "replaces": SOURCES[k][2], "launches": counts[k],
                **{f: results[k][f] for f in LINE_FIELDS}}
               for k in SOURCES]
    log(smi)   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
