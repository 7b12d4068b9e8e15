# Copied from spacer_tpu/vision/smart.py (numpy / stdlib only; no JAX).
"""Frame-count and resolution scheduling with qwen-vl-utils parity.

Behavioral reference: vision_process.py:25-87 (constants, factor rounding,
smart_resize) and vision_process.py:145-182 (smart_nframes) plus the per-frame
pixel budget at vision_process.py:288-295.  These are pure host-side integer
functions; they decide the static shapes the TPU pipeline compiles for, so
they must be bit-exact with the reference scheduling.
"""

from __future__ import annotations

import math
import os

# Image token geometry: ViT patch 14 x spatial-merge 2 => resolution factor 28.
IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 256 * 28 * 28
MAX_RATIO = 200

# Video budgets (vision_process.py:32-42). The SpaceR fork pins per-frame video
# pixels to exactly 128 * 28^2 (min == max).
VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 128 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 16


def video_total_pixels() -> int:
    """Total pixel budget across all sampled frames (env-overridable)."""
    return int(float(os.environ.get("VIDEO_MAX_PIXELS", 128000 * 28 * 28 * 0.9)))


def round_by_factor(number: float, factor: int) -> int:
    """Closest integer to `number` divisible by `factor` (banker's rounding,
    matching Python round())."""
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    """Smallest integer >= `number` divisible by `factor`."""
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    """Largest integer <= `number` divisible by `factor`."""
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> tuple[int, int]:
    """Target (height, width) with both dims divisible by `factor`, total pixels
    inside [min_pixels, max_pixels], aspect ratio approximately preserved.

    Parity with vision_process.py:61-87 including the >MAX_RATIO aspect guard
    and the floor-on-shrink / ceil-on-grow asymmetry.
    """
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            "absolute aspect ratio must be smaller than "
            f"{MAX_RATIO}, got {max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Number of frames to sample for a video (vision_process.py:145-182).

    `ele` may carry either `nframes` (explicit, rounded to FRAME_FACTOR) or
    `fps` + optional `min_frames`/`max_frames`.
    """
    assert not ("fps" in ele and "nframes" in ele), (
        "Only accept either `fps` or `nframes`"
    )
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)), FRAME_FACTOR
        )
        nframes = total_frames / video_fps * fps
        nframes = min(min(max(nframes, min_frames), max_frames), total_frames)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], "
            f"but got {nframes}."
        )
    return nframes


def sample_frame_indices(total_frames: int, nframes: int) -> list[int]:
    """Evenly spaced frame indices, matching torch.linspace(...).round().long()
    (vision_process.py:216, 252). torch.linspace rounds half away from zero is
    irrelevant here since values are non-negative; round-half-to-even vs
    half-up can differ, so replicate torch's float32 linspace + round-half-to
    -nearest-even exactly via numpy.
    """
    import numpy as np

    if nframes == 1:
        return [0]
    idx = np.linspace(0, total_frames - 1, nframes, dtype=np.float64)
    # torch.round uses round-half-to-even, same as numpy.
    return np.round(idx).astype(np.int64).tolist()


def video_frame_pixel_budget(
    nframes: int,
    min_pixels: int | None = None,
    total_pixels: int | None = None,
    max_pixels_supposed: int | None = None,
) -> tuple[int, float]:
    """(min_pixels, max_pixels) budget per frame for a sampled video.

    Parity with fetch_video's budget arithmetic (vision_process.py:288-295):
    max_pixels shrinks as total budget / nframes * FRAME_FACTOR, floored at
    1.05x min_pixels, and capped by an explicit user max_pixels if given.
    max_pixels is kept as a float (the reference passes the raw division
    result into smart_resize).
    """
    if min_pixels is None:
        min_pixels = VIDEO_MIN_PIXELS
    if total_pixels is None:
        total_pixels = video_total_pixels()
    max_pixels = max(
        min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
        int(min_pixels * 1.05),
    )
    if max_pixels_supposed is not None:
        max_pixels = min(max_pixels_supposed, max_pixels)
    return min_pixels, max_pixels
