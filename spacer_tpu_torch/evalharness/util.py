# Copied from spacer_tpu/evalharness/util.py; only its imports point at spacer_tpu_torch.
"""Shared eval utilities (SpaceR-Eval/util.py parity)."""

from __future__ import annotations

import json
import os
import re
from datetime import timedelta

import numpy as np


def extract_answer_text(text_with_tags: str) -> str:
    """First <answer> block, or the string "None" (util.py:16-21 — note the
    different no-match default vs the trainer-side extractor)."""
    m = re.search(r"<answer>(.*?)</answer>", text_with_tags, re.DOTALL)
    return m.group(1).strip() if m else "None"


def format_time(elapsed_seconds: float) -> str:
    td = timedelta(seconds=int(elapsed_seconds))
    h = td.seconds // 3600
    m = (td.seconds % 3600) // 60
    s = td.seconds % 60
    return f"{h:02}h{m:02}m{s:02}s"


def merge_results(world_size: int, output_file: str, task: str) -> None:
    """Concatenate per-rank jsonl shards (evaluate.py:22-41)."""
    with open(output_file, "w") as out:
        for rank in range(world_size):
            shard = os.path.join(
                os.path.dirname(output_file),
                f"{task}_results_rank_{rank}.jsonl",
            )
            if os.path.exists(shard):
                with open(shard) as f:
                    out.write(f.read())


def _resize_frame(image, max_size: int = 448):
    """Aspect cap at max_size (util.py:184-195 parity).

    NOTE (reference quirk, reproduced deliberately): the reference unpacks
    PIL's (width, height) `.size` as (h, w) and then passes the computed
    values to `Image.resize((new_w, new_h))`, which TRANSPOSES the aspect
    ratio of any frame larger than max_size (landscape in, portrait out).
    Eval numbers were produced under this behavior, so parity requires it.
    """
    from PIL import Image

    h, w = image.size  # actually (width, height) — see note
    if max(h, w) <= max_size:
        return image
    if h > w:
        new_h = max_size
        new_w = int(w * (max_size / h))
    else:
        new_w = max_size
        new_h = int(h * (max_size / w))
    return image.resize((new_w, new_h), Image.Resampling.LANCZOS)


def load_video_frames(video_path: str, num_frames: int = 4, fps: float = 1,
                      target_resolution=(256, 256)):
    """Evenly spaced frames as PIL images + integer timestamps + duration
    (util.py:182-215 semantics; decode via OpenCV/native instead of decord).

    Returns (frames, timestamps, duration) or (None, None, None) on error.
    """
    from PIL import Image

    try:
        from spacer_tpu_torch.vision.reader import probe_video

        total_frames, video_fps = probe_video(video_path)
        duration = int(total_frames / video_fps) if video_fps > 0 else int(
            total_frames / 30
        )
        if fps > 0:
            target = max(1, min(num_frames, int(duration * fps)))
        else:
            target = num_frames
        idx = np.linspace(0, total_frames - 1, target, dtype=int)

        import cv2

        wanted = sorted(set(int(i) for i in idx))
        by_index = {}
        cap = cv2.VideoCapture(video_path)
        try:
            pos = 0
            while pos <= wanted[-1]:
                if pos in wanted:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    by_index[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                else:
                    if not cap.grab():
                        break
                pos += 1
        finally:
            cap.release()
        if not by_index:
            return None, None, None
        last = by_index[max(by_index)]
        max_size = max(target_resolution)
        frames = [
            _resize_frame(Image.fromarray(by_index.get(int(i), last)), max_size)
            for i in idx
        ]
        if video_fps > 0:
            timestamps = [int(i / video_fps) for i in idx]
        else:
            timestamps = [int(i / 30) for i in idx]
        return frames, timestamps, duration
    except Exception:
        return None, None, None


def write_jsonl(path: str, records: list[dict]) -> str:
    with open(path, "w") as f:
        for r in records:
            json.dump(r, f, ensure_ascii=False, default=str)
            f.write("\n")
    return path


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
