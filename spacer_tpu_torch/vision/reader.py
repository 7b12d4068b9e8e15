# Copied from spacer_tpu/vision/reader.py; only its imports point at spacer_tpu_torch.
"""Host-side video decoding backends.

Replaces the reference's decord dependency (vision_process.py:228-256,
SpaceR-Eval/util.py:182-215).  Two backends:

- "native": the in-tree C++ FFmpeg decoder (native/video_decoder.cc) loaded
  via ctypes — the production path (grab-and-skip decode, no Python per-frame
  overhead).
- "opencv": cv2.VideoCapture fallback, always available.

Backend selection: env SPACER_VIDEO_READER, else native when the shared
library is built, else opencv.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from spacer_tpu_torch.vision.smart import sample_frame_indices, smart_nframes


def _probe_opencv(path: str) -> tuple[int, float]:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        return total, fps
    finally:
        cap.release()


def _clip_range(ele: dict, total_frames: int, fps: float) -> tuple[int, int]:
    """(first_frame, n_frames) of the [video_start, video_end] second window.

    Contract matches torchvision.io.read_video(start_pts, end_pts,
    pts_unit='sec') as used by the reference (vision_process.py:206-209):
    frame i (pts = i/fps) is included when start <= i/fps <= end, both ends
    inclusive.
    """
    start = ele.get("video_start")
    end = ele.get("video_end")
    if start is None and end is None:
        return 0, total_frames
    lo = 0 if start is None else int(np.ceil(float(start) * fps - 1e-6))
    hi = (total_frames - 1 if end is None
          else int(np.floor(float(end) * fps + 1e-6)))
    lo = max(0, lo)
    hi = min(hi, total_frames - 1)
    if hi < lo or lo >= total_frames:
        raise ValueError(
            f"empty clip window [{start}, {end}]s at {fps} fps "
            f"({total_frames} frames)"
        )
    return lo, hi - lo + 1


def _read_video_opencv(ele: dict) -> tuple[np.ndarray, float]:
    """Sequential decode with cheap grab-skips; returns (T, H, W, C) RGB uint8."""
    import cv2

    path = ele["video"]
    if path.startswith("file://"):
        path = path[7:]
    total_frames, video_fps = _probe_opencv(path)
    first, n_clip = _clip_range(ele, total_frames, video_fps)
    nframes = smart_nframes(ele, total_frames=n_clip, video_fps=video_fps)
    idx = np.asarray(sample_frame_indices(n_clip, nframes)) + first
    wanted = set(idx)
    frames_by_index: dict[int, np.ndarray] = {}
    cap = cv2.VideoCapture(path)
    try:
        pos = 0
        max_idx = max(idx)
        while pos <= max_idx:
            if pos in wanted:
                ok, frame = cap.read()
                if not ok:
                    break
                frames_by_index[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            else:
                if not cap.grab():
                    break
            pos += 1
    finally:
        cap.release()
    if not frames_by_index:
        raise IOError(f"decoded no frames from {path}")
    last = frames_by_index[max(frames_by_index)]
    frames = np.stack([frames_by_index.get(i, last) for i in idx])
    sample_fps = nframes / max(n_clip, 1e-6) * video_fps
    return frames, sample_fps


def _native_lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libspacer_video.so",
    )


@functools.lru_cache(maxsize=1)
def _load_native():
    from spacer_tpu_torch.vision import native_decoder

    return native_decoder.NativeDecoder(_native_lib_path())


def _read_video_native(ele: dict) -> tuple[np.ndarray, float]:
    dec = _load_native()
    path = ele["video"]
    if path.startswith("file://"):
        path = path[7:]
    total_frames, video_fps = dec.probe(path)
    first, n_clip = _clip_range(ele, total_frames, video_fps)
    nframes = smart_nframes(ele, total_frames=n_clip, video_fps=video_fps)
    idx = np.asarray(sample_frame_indices(n_clip, nframes)) + first
    frames = dec.read_frames(path, idx)
    sample_fps = nframes / max(n_clip, 1e-6) * video_fps
    return frames, sample_fps


VIDEO_READER_BACKENDS = {
    "native": _read_video_native,
    "opencv": _read_video_opencv,
}


@functools.lru_cache(maxsize=1)
def get_video_reader_backend() -> str:
    forced = os.environ.get("SPACER_VIDEO_READER")
    if forced:
        return forced
    if os.path.exists(_native_lib_path()):
        return "native"
    return "opencv"


def read_video(ele: dict) -> tuple[np.ndarray, float]:
    """Decode + sample frames per smart_nframes; (T,H,W,C) RGB uint8, fps."""
    backend = get_video_reader_backend()
    try:
        return VIDEO_READER_BACKENDS[backend](ele)
    except Exception:
        if backend != "opencv":
            return _read_video_opencv(ele)
        raise


def probe_video(path: str) -> tuple[int, float]:
    """(total_frames, fps) without decoding."""
    backend = get_video_reader_backend()
    if backend == "native":
        try:
            return _load_native().probe(path)
        except Exception:
            pass
    return _probe_opencv(path)
