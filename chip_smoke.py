"""Smoke test of spacer_tpu_torch on one NVIDIA Hopper GPU (H100).

Phases, in order; any failure raises and the script exits non-zero:
  1. device facts (CUDA device of capability 9.0 required; no CPU path);
  2. build the CUDA kernels from spacer_tpu_torch/csrc with nvcc;
  3. each kernel (K1, K3, K4, K5) against its plain PyTorch version on the
     card at the serving path's shapes, bf16: max abs error and median time;
  4. the serving slice end to end at the full Qwen2.5-VL-7B geometry
     (random bf16 weights from a seed): 2 video + 2 text requests through
     QwenEngine.generate_many, greedy; every request must emit a token, all
     logits must be finite and every kernel must have been launched; then
     the same requests with plain attention and the first run's tokens
     replayed, whose logits must agree with the kernel run's.
The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
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
TIMED_RUNS = 25


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
    from spacer_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{[l for l in nvcc.splitlines() if 'release' in l][0].strip()}")
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


def compare(name, kernel_fn, plain_fn, select=lambda x: x):
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
    err, within = 0.0, True
    for o, r in zip(out, ref):
        o, r = select(o).float(), select(r).float()
        diff = (o - r).abs()
        err = max(err, float(diff.max()))
        within &= bool((diff <= BF16_TOL * (1 + r.abs())).all())
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    log(f"{name}: max_abs_err {err:.3e} (tol {BF16_TOL:.0e} * (1 + |ref|)) | "
        f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
    if not (finite and within):
        raise RuntimeError(f"{name} disagrees with its plain version: "
                           f"err {err} finite {finite}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_kernels() -> dict:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout
    from spacer_tpu_torch.nn.attention import xla_attention
    from spacer_tpu_torch.ops import flash_decode as fd
    from spacer_tpu_torch.ops import vit_window_attention as vwa
    from spacer_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
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
    results["K1"] = compare(
        "K1 flash_attention", lambda: flash_attention(q, k, v, **kw),
        lambda: xla_attention(q, k, v, **kw), rows)

    # K5: decode, R=8 slots, Hkv=4, gq=7, Pmax=1024, Cmax=128
    R, gq, C = 8, 7, 128
    qd = randn(R, Hkv, gq, D)
    pk, pv = randn(R, Hkv, P, D), randn(R, Hkv, P, D)
    tk, tv = randn(R, Hkv, C, D), randn(R, Hkv, C, D)
    plen = torch.tensor([1024, 900, 517, 64, 1, 0, 700, 0], device=dev)
    tlen = torch.tensor([128, 5, 77, 1, 0, 0, 64, 0], device=dev)
    admit = torch.tensor([0, 120, 60, 9, 0, 0, 100, 0], device=dev)
    pmask = torch.arange(P, device=dev)[None] >= (P - plen)[:, None]
    rel = torch.remainder(torch.arange(C, device=dev)[None] - admit[:, None], C)
    rmask = rel < tlen[:, None]
    bias_p = torch.where(pmask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    bias_t = torch.where(rmask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    live = pmask.any(1) | rmask.any(1)
    dargs = (qd, pk, pv, bias_p, tk, tv, bias_t)
    dkw = dict(group_q=gq, sm_scale=D ** -0.5)
    out_all = fd.flash_ragged_decode_attention(*dargs, **dkw)
    if not bool(torch.isfinite(out_all).all()):
        raise RuntimeError("K5 wrote non-finite values (empty slots included)")
    results["K5"] = compare(
        "K5 flash_ragged_decode_attention",
        lambda: fd.flash_ragged_decode_attention(*dargs, **dkw),
        lambda: fd.ragged_decode_attention_reference(*dargs, **dkw),
        lambda x: x[live])

    # K3 / K4: ViT at grid (8, 16, 30): 16 heads, head_dim 80
    vcfg = QWEN25_VL_7B.vision
    layout = vision_layout([(8, 16, 30)], vcfg)
    n_win, wt = layout.win_gather.shape
    Hv, Dv = vcfg.num_heads, vcfg.head_dim
    scale = Dv ** -0.5
    qw, kw3, vw = (randn(Hv, n_win * wt, Dv) for _ in range(3))
    bias = torch.from_numpy(vwa.validity_bias(layout.win_valid.sum(1), wt)).to(dev)
    results["K3"] = compare(
        f"K3 window_attention_hsd (16, {n_win * wt}, 80) wt={wt}",
        lambda: vwa.window_attention_hsd(qw, kw3, vw, bias, wt, scale),
        lambda: vwa.window_attention_reference(qw, kw3, vw, bias, wt, scale))
    S, chunk = layout.seq_len, layout.full_chunk
    qc, kc, vc = (randn(Hv, S, Dv) for _ in range(3))
    results["K4"] = compare(
        f"K4 chunk_attention_hsd (16, {S}, 80) wt={chunk}",
        lambda: vwa.chunk_attention_hsd(qc, kc, vc, chunk, scale),
        lambda: vwa.chunk_attention_reference(qc, kc, vc, chunk, scale))
    return results


class SliceProbe:
    """Observes the serving slice from outside: wraps the batcher's prologue
    (ViT), prefill, decode step, sampler and harvest with synchronised
    timers and finiteness checks, and records every sampled step's logits
    and tokens.  With `replay` (the tokens of an earlier run) the sampler
    returns those tokens instead, so a second run sees identical inputs at
    every step."""

    def __init__(self, replay=None):
        import spacer_tpu_torch.serving.batcher as bm

        self.bm, self.replay = bm, replay
        self.vit_ms, self.prefill_ms, self.decode_ms = [], [], []
        self.lengths, self.nonfinite = [], 0
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
            self.logits.append(logits.float())
            self.tokens.append(tokens)
            return tokens

        def poll_finished(batcher):
            done = poll(batcher)
            self.lengths += [o.length for _, o in done]
            return done

        bm.prologue = timed_prologue
        bm.lm_forward = self._timed(self.prefill_ms, lm_forward, True)
        bm.ragged_decode_step = self._timed(self.decode_ms, step, True)
        bm.sample_logits = recorded_sample
        bm.ContinuousBatcher.poll_finished = poll_finished
        return self

    def __exit__(self, *exc):
        (self.bm.prologue, self.bm.lm_forward, self.bm.ragged_decode_step,
         self.bm.sample_logits, self.bm.ContinuousBatcher.poll_finished) = \
            self._saved


class PlainAttention:
    """For a reference run only: routes the slice's four attention calls to
    the kernels' plain versions (the library itself has no such switch)."""

    def __enter__(self):
        import spacer_tpu_torch.models.qwen25_vl.language as lang
        import spacer_tpu_torch.models.qwen25_vl.vision as vis
        import spacer_tpu_torch.serving.ragged as rag
        from spacer_tpu_torch.nn.attention import xla_attention
        from spacer_tpu_torch.ops import flash_decode as fd
        from spacer_tpu_torch.ops import vit_window_attention as vwa

        self.routes = [
            (lang, "dot_product_attention", xla_attention),
            (vis, "window_attention_hsd", vwa.window_attention_reference),
            (vis, "chunk_attention_hsd", vwa.chunk_attention_reference),
            (rag, "flash_ragged_decode_attention",
             fd.ragged_decode_attention_reference),
        ]
        self.saved = [getattr(m, n) for m, n, _ in self.routes]
        for m, n, plain in self.routes:
            setattr(m, n, plain)
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.routes, self.saved):
            setattr(m, n, fn)


def serve_slice(cfg, device="cuda") -> dict:
    """Phase 4: the serving slice (at full Qwen2.5-VL-7B geometry when
    called from main), then the same requests again with the kernels
    replaced by their plain versions and the first run's tokens replayed:
    the logits of every sampled step must agree."""
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

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
    gen_kw = dict(max_new_tokens=64, temperature=0.0, slots=4)
    engine = QwenEngine(cfg, params, proc)
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
    log(f"slice: {len(texts)} completions, lengths {probe.lengths}, video grid "
        f"{grid}, wall {wall:.2f} s, {tokens / wall:.1f} generated tok/s")
    log(f"slice: ViT encode ms {[round(x, 2) for x in probe.vit_ms]} | prefill "
        f"ms per admission {[round(x, 2) for x in probe.prefill_ms]} | decode "
        f"ms per step median {statistics.median(probe.decode_ms):.2f} over "
        f"{len(probe.decode_ms)} steps")
    log(f"slice: launches {counts} | max_memory_allocated {peak / 2**30:.2f} GiB")
    if len(probe.lengths) != len(msgs) or min(probe.lengths) < 1:
        raise RuntimeError(f"a request emitted no token: {probe.lengths}")
    if probe.nonfinite:
        raise RuntimeError(f"{probe.nonfinite} non-finite logits tensors")
    if grid != ((8, 16, 30),):
        raise RuntimeError(f"unexpected video grid {grid}")
    if min(counts.values()) < 1:
        raise RuntimeError(f"a kernel of the path was never launched: {counts}")

    # reference run: plain attention everywhere, the kernel run's tokens
    with PlainAttention(), SliceProbe(replay=probe.tokens) as ref:
        QwenEngine(cfg, params, proc).generate_many(msgs, **gen_kw)
    if launch_counts() != counts or len(ref.logits) != len(probe.logits):
        raise RuntimeError("the reference run launched a kernel or took "
                           "other steps")
    cos = torch.stack([torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
                       for a, b in zip(probe.logits, ref.logits)])
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(probe.logits, ref.logits)]).mean()
    log(f"slice vs plain attention: logits cosine min {float(cos.min()):.5f} "
        f"median {float(cos.median()):.5f} over {len(cos)} sampled steps "
        f"(tol {SLICE_COS_TOL}) | greedy argmax agreement {float(agree):.4f}")
    if not float(cos.min()) >= SLICE_COS_TOL:
        raise RuntimeError("the kernel path's logits disagree with the plain "
                           "attention path")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "K1": ("flash_attention", "spacer_tpu_torch/csrc/flash_attention.cu",
           "spacer_tpu/ops/flash_attention.py:452"),
    "K3": ("window_attention_hsd", "spacer_tpu_torch/csrc/vit_window_attention.cu",
           "spacer_tpu/ops/vit_window_attention.py:116"),
    "K4": ("chunk_attention_hsd", "spacer_tpu_torch/csrc/vit_window_attention.cu",
           "spacer_tpu/ops/vit_window_attention.py:187"),
    "K5": ("flash_ragged_decode_attention", "spacer_tpu_torch/csrc/flash_decode.cu",
           "spacer_tpu/ops/flash_decode.py:398"),
}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = device_facts()
    build_kernels()
    results = check_kernels()
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    counts = serve_slice(QWEN25_VL_7B)
    kernels = [{"name": SOURCES[k][0], "route": "cuda", "source": SOURCES[k][1],
                "replaces": SOURCES[k][2], "launches": counts[k], **results[k]}
               for k in SOURCES]
    log(smi)   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
