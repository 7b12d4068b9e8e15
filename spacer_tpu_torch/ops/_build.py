"""Build and load the hand-written Hopper kernels of spacer_tpu_torch/csrc.

Every `csrc/*.cu` is compiled by nvcc, on first use, into ONE shared library
with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`), which is
loaded with ctypes.  Nothing here includes PyTorch's headers, so a build
takes seconds.  The library's name carries a hash of the sources and flags,
so an edited source never loads a stale build.  The build directory is
`<repo>/build/spacer_tpu_torch` (override: SPACER_TORCH_BUILD_DIR).

Nothing is compiled or loaded at import time: `kernels()` does it on the
first launch.  `takes_plain` is every wrapper's choice between its kernel
and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points: name -> argtypes.  Each returns cudaGetLastError().
SIGNATURES = {
    # q, k, v, out, lse, kv_valid, q_seg, kv_seg, v_mean,
    # B, Sq, Skv, Hq, Hkv, D, causal, q_offset, scale, stream
    "spacer_flash_attention_fwd": [P] * 9 + [I] * 8 + [F, P],
    # q, k, v, bias, out, H, S, D, wt, scale, stream
    "spacer_window_attention_hsd": [P] * 5 + [I] * 4 + [F, P],
    # q, k, v, out, H, S, D, wt, scale, stream
    "spacer_chunk_attention_hsd": [P] * 4 + [I] * 4 + [F, P],
    # q, pk, pv, bias_p, tk, tv, bias_t, scratch, out,
    # R, Hkv, gq, P, C, D, scale, stream
    "spacer_ragged_decode_attention": [P] * 9 + [I] * 6 + [F, P],
    # () -> keys per split-K job of K5 and K2 (csrc/decode_job.cuh)
    "spacer_decode_job_keys": [],
    # q, k, v, dout, lse, delta, dq, kv_valid, q_seg, kv_seg,
    # B, Sq, Skv, Hq, Hkv, D, causal, q_offset, scale, stream
    "spacer_flash_attention_bwd_dq": [P] * 10 + [I] * 8 + [F, P],
    # q, k, v, dout, lse, delta, dk, dv, partial, kv_valid, q_seg, kv_seg,
    # B, Sq, Skv, Hq, Hkv, D, causal, q_offset, splits, scale, stream
    "spacer_flash_attention_bwd_dkv": [P] * 12 + [I] * 9 + [F, P],
    # () -> keys per dk/dv CTA
    "spacer_flash_attention_bwd_dkv_keys": [],
    # q, pk, pv, bias_p, tk, tv, part_o, part_lse, out,
    # B, Hkv, G, gq, P, T, step, D, scale, stream
    "spacer_grouped_decode_attention": [P] * 9 + [I] * 8 + [F, P],
    # q, pk, pv, bias_p, tk, tv, bias_t, pk_s, pv_s, tk_s, tv_s, scratch,
    # out, R, Hkv, gq, P, C, D, scale, stream
    "spacer_ragged_decode_attention_int8": [P] * 13 + [I] * 6 + [F, P],
    # q, pk, pv, bias_p, tk, tv, pk_s, pv_s, tk_s, tv_s, part_o, part_lse, out,
    # B, Hkv, G, gq, P, T, step, D, scale, stream
    "spacer_grouped_decode_attention_int8": [P] * 13 + [I] * 8 + [F, P],
    # x, packed, row_scale, col_scale, bias, part, tickets, out,
    # M, K, N, bk, splits, rows, stream
    "spacer_int4_matmul": [P] * 8 + [I] * 6 + [P],
    # () -> K6 CTAs an SM holds at once
    "spacer_int4_matmul_ctas_per_sm": [],
}

# the Counters of the open utils.debugging.interpret_kernels contexts
INTERPRET: list = []


def takes_plain(t, kernel: str) -> bool:
    """Whether a wrapper runs its plain version on tensor `t`: always on a
    CPU tensor; on a CUDA tensor only inside interpret_kernels, which counts
    the call under `kernel`.  Otherwise the wrapper launches or raises."""
    if t.device.type == "cpu":
        return True
    if INTERPRET:
        INTERPRET[-1][kernel] += 1
        return True
    return False


def build_dir() -> Path:
    env = os.environ.get("SPACER_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "spacer_tpu_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of spacer_tpu_torch "
                       "are built from csrc/*.cu on first use")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libspacer_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with nvcc's output on a failure."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one nvcc
    per source, all started together, then one link."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = lib.parent / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(_start([_nvcc(), *compile_flags, "-c", "-o", str(obj),
                             str(src)]))
    try:
        _run(procs)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        _run([_start([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                      *map(str, objs)])])
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spacer_error_string.argtypes = [ctypes.c_int]
    lib.spacer_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = kernels().spacer_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError {err} ({msg})")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
