# Copied from spacer_tpu/vision/native_decoder.py (numpy / stdlib only; no JAX).
"""ctypes binding for the in-tree FFmpeg decoder (native/video_decoder.cc)."""

from __future__ import annotations

import ctypes

import numpy as np


class _VdInfo(ctypes.Structure):
    _fields_ = [
        ("total_frames", ctypes.c_int64),
        ("fps", ctypes.c_double),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
    ]


class NativeDecoder:
    def __init__(self, lib_path: str):
        self._lib = ctypes.CDLL(lib_path)
        self._lib.vd_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_VdInfo)]
        self._lib.vd_probe.restype = ctypes.c_int
        self._lib.vd_read_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
        ]
        self._lib.vd_read_frames.restype = ctypes.c_int

    def probe(self, path: str) -> tuple[int, float]:
        info = _VdInfo()
        rc = self._lib.vd_probe(path.encode(), ctypes.byref(info))
        if rc != 0:
            raise IOError(f"vd_probe({path}) failed: {rc}")
        return int(info.total_frames), float(info.fps)

    def probe_full(self, path: str) -> _VdInfo:
        info = _VdInfo()
        rc = self._lib.vd_probe(path.encode(), ctypes.byref(info))
        if rc != 0:
            raise IOError(f"vd_probe({path}) failed: {rc}")
        return info

    def read_frames(self, path: str, indices: list[int]) -> np.ndarray:
        """Decode frames at `indices` -> (len(indices), H, W, 3) RGB uint8.

        Indices may repeat and must be non-decreasing overall semantics-wise;
        we decode the sorted unique set and gather."""
        info = self.probe_full(path)
        uniq = sorted(set(int(i) for i in indices))
        n = len(uniq)
        arr = np.empty((n, info.height, info.width, 3), np.uint8)
        idx = (ctypes.c_int64 * n)(*uniq)
        rc = self._lib.vd_read_frames(
            path.encode(), idx, n,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            info.width, info.height,
        )
        if rc < 0:
            raise IOError(f"vd_read_frames({path}) failed: {rc}")
        lookup = {f: i for i, f in enumerate(uniq)}
        return arr[[lookup[int(i)] for i in indices]]
