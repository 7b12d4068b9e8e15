"""Multimodal processor: chat template + tokenize + vision-token expansion
(counterpart of spacer_tpu/data/processor.py; the pixel pipeline runs in
PyTorch on the processor's `device`).

Replaces HF AutoProcessor for Qwen2.5-VL (processing_qwen2_5_vl.py): renders
the canonical Qwen chat template, expands <|video_pad|>/<|image_pad|> into
grid_t*grid_h*grid_w / merge^2 placeholder tokens, left-pads the batch, and
returns pixel_values + grid tensors from spacer_tpu_torch.vision.

Tokenizer: any object with .encode(text, add_special_tokens=False) ->
list[int] and .decode(ids, skip_special_tokens=...) (an HF tokenizer loaded
from a local checkpoint dir qualifies). MockTokenizer supports tests without
checkpoint files.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np

from spacer_tpu_torch.models.qwen25_vl.config import Qwen25VLConfig
from spacer_tpu_torch.vision.process import (
    MERGE_SIZE,
    PATCH_SIZE,
    TEMPORAL_PATCH_SIZE,
    preprocess_frames,
    process_vision_info,
)
from spacer_tpu_torch.vision.smart import smart_resize

VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

DEFAULT_SYSTEM = "You are a helpful assistant."


def _content_to_text(content) -> str:
    """Render one message's content per the official Qwen2.5-VL template."""
    if isinstance(content, str):
        return content
    parts = []
    for ele in content:
        t = ele.get("type")
        if t == "image" or "image" in ele or "image_url" in ele:
            parts.append(VISION_START + IMAGE_PAD + VISION_END)
        elif t == "video" or "video" in ele:
            parts.append(VISION_START + VIDEO_PAD + VISION_END)
        elif t == "text" or "text" in ele:
            parts.append(ele.get("text", ""))
    return "".join(parts)


def render_chat_template(messages: Sequence[dict],
                         add_generation_prompt: bool = True) -> str:
    """Canonical Qwen2.5-VL chat template (chat_template.json semantics):
    a default system message is inserted when none is present."""
    out = []
    if not messages or messages[0].get("role") != "system":
        out.append(f"{IM_START}system\n{DEFAULT_SYSTEM}{IM_END}\n")
    for m in messages:
        out.append(
            f"{IM_START}{m['role']}\n{_content_to_text(m['content'])}{IM_END}\n"
        )
    if add_generation_prompt:
        out.append(f"{IM_START}assistant\n")
    return "".join(out)


class MockTokenizer:
    """Whitespace/byte-level tokenizer with the Qwen special tokens, for
    tests and offline smoke runs (no checkpoint files needed)."""

    SPECIALS = {
        "<|endoftext|>": 0, "<|im_start|>": 1, "<|im_end|>": 2,
        "<|vision_start|>": 4, "<|vision_end|>": 5, "<|image_pad|>": 6,
        "<|video_pad|>": 7,
    }

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        self.eos_token_id = self.SPECIALS["<|im_end|>"]
        self.pad_token_id = self.SPECIALS["<|endoftext|>"]
        self._n_special = 10
        self._id2tok = {v: k for k, v in self.SPECIALS.items()}

    def _word_id(self, w: str) -> int:
        return self._n_special + (hash(w) % (self.vocab_size - self._n_special))

    def encode(self, text: str, add_special_tokens: bool = False):
        pattern = "|".join(re.escape(s) for s in self.SPECIALS)
        ids = []
        for piece in re.split(f"({pattern})", text):
            if not piece:
                continue
            if piece in self.SPECIALS:
                ids.append(self.SPECIALS[piece])
            else:
                ids.extend(self._word_id(w) for w in piece.split())
        return ids

    def decode(self, ids, skip_special_tokens: bool = True):
        toks = []
        for i in ids:
            i = int(i)
            if i in self._id2tok:
                if not skip_special_tokens:
                    toks.append(self._id2tok[i])
            else:
                toks.append(f"w{i}")
        return " ".join(toks)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]


class VLProcessor:
    """text + videos/images -> model-ready arrays.

    Mirrors the HF processor contract: returns dict with input_ids,
    attention_mask (left padding), pixel_values_videos/video_grid_thw and/or
    pixel_values/image_grid_thw, plus second_per_grid_ts.
    """

    def __init__(self, tokenizer, cfg: Qwen25VLConfig | None = None,
                 min_pixels: int | None = None,
                 max_pixels: int | None = None, device="cpu"):
        self.tokenizer = tokenizer
        self.device = device
        self.cfg = cfg or Qwen25VLConfig()
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.merge = self.cfg.vision.spatial_merge_size

    @property
    def eos_token_id(self):
        return self.tokenizer.eos_token_id

    @property
    def pad_token_id(self):
        pid = getattr(self.tokenizer, "pad_token_id", None)
        return pid if pid is not None else self.cfg.pad_token_id

    def apply_chat_template(self, messages, add_generation_prompt=True):
        return render_chat_template(messages, add_generation_prompt)

    # -- vision --------------------------------------------------------
    def _prep_video(self, video) -> tuple[np.ndarray, tuple[int, int, int]]:
        """video: float/uint8 (T, C, H, W) (fetch_video output) or a list of
        PIL frames. Returns (pixel_values, grid)."""
        if isinstance(video, (list, tuple)):  # PIL frames (eval path)
            frames = np.stack([np.asarray(f) for f in video])  # THWC
            return preprocess_frames(
                frames,
                min_pixels=self.min_pixels, max_pixels=self.max_pixels,
                device=self.device,
            )
        arr = np.asarray(video)
        if arr.ndim != 4:
            raise ValueError(f"bad video shape {arr.shape}")
        frames = arr.transpose(0, 2, 3, 1)  # TCHW -> THWC
        h, w = frames.shape[1], frames.shape[2]
        # fetch_video already smart-resized; re-run smart_resize with the
        # processor budget (identity when dims already fit, HF parity)
        rh, rw = smart_resize(
            h, w, PATCH_SIZE * MERGE_SIZE,
            self.min_pixels if self.min_pixels is not None else 56 * 56,
            self.max_pixels if self.max_pixels is not None else 12845056,
        )
        return preprocess_frames(frames, resized_hw=(rh, rw),
                                 device=self.device)

    def _prep_image(self, image) -> tuple[np.ndarray, tuple[int, int, int]]:
        frames = np.asarray(image)[None]  # (1, H, W, C)
        return preprocess_frames(
            frames, min_pixels=self.min_pixels, max_pixels=self.max_pixels,
            device=self.device,
        )

    # -- main ----------------------------------------------------------
    def __call__(self, text, images=None, videos=None, fps=None,
                 padding_side: str = "left"):
        if isinstance(text, str):
            text = [text]
        images = list(images) if images else []
        videos = list(videos) if videos else []
        fps = list(fps) if fps else [2.0] * len(videos)

        pixel_videos, video_grids, spg_ts = [], [], []
        for v, f in zip(videos, fps):
            px, grid = self._prep_video(v)
            pixel_videos.append(px)
            video_grids.append(grid)
            spg_ts.append(TEMPORAL_PATCH_SIZE / f)
        pixel_images, image_grids = [], []
        for im in images:
            px, grid = self._prep_image(im)
            pixel_images.append(px)
            image_grids.append(grid)

        vid_iter = iter(enumerate(video_grids))
        img_iter = iter(enumerate(image_grids))
        all_ids = []
        media_order: list[tuple[str, int]] = []  # appearance order, batchwide
        for t in text:
            ids = []
            pattern = re.escape(IMAGE_PAD) + "|" + re.escape(VIDEO_PAD)
            pos = 0
            for m in re.finditer(pattern, t):
                ids.extend(self.tokenizer.encode(t[pos:m.start()],
                                                 add_special_tokens=False))
                if m.group(0) == VIDEO_PAD:
                    k, g = next(vid_iter)
                    n = (g[0] * g[1] * g[2]) // (self.merge ** 2)
                    ids.extend([self.cfg.video_token_id] * n)
                    media_order.append(("video", k))
                else:
                    k, g = next(img_iter)
                    n = (g[0] * g[1] * g[2]) // (self.merge ** 2)
                    ids.extend([self.cfg.image_token_id] * n)
                    media_order.append(("image", k))
                pos = m.end()
            ids.extend(self.tokenizer.encode(t[pos:], add_special_tokens=False))
            all_ids.append(ids)

        max_len = max(len(i) for i in all_ids)
        B = len(all_ids)
        input_ids = np.full((B, max_len), self.pad_token_id, np.int32)
        attention_mask = np.zeros((B, max_len), np.int32)
        for b, ids in enumerate(all_ids):
            if padding_side == "left":
                input_ids[b, max_len - len(ids):] = ids
                attention_mask[b, max_len - len(ids):] = 1
            else:
                input_ids[b, : len(ids)] = ids
                attention_mask[b, : len(ids)] = 1

        out: dict[str, Any] = {
            "input_ids": input_ids, "attention_mask": attention_mask,
        }
        if pixel_videos:
            out["pixel_values_videos"] = np.concatenate(pixel_videos, axis=0)
            out["video_grid_thw"] = np.asarray(video_grids, np.int64)
            out["second_per_grid_ts"] = np.asarray(spg_ts, np.float32)
        if pixel_images:
            out["pixel_values"] = np.concatenate(pixel_images, axis=0)
            out["image_grid_thw"] = np.asarray(image_grids, np.int64)
        if media_order:
            out["media_order"] = media_order
        return out

    def process_messages(self, messages_batch, add_generation_prompt=True,
                         min_pixels=None, max_pixels=None):
        """High-level: message lists -> arrays (template + vision + expand).

        Vision elements inside messages carry paths/frames (reference
        contract: SG_RLVR_trainer.py:396-414).
        """
        texts = [
            self.apply_chat_template(m, add_generation_prompt)
            for m in messages_batch
        ]
        # inject processor-level pixel budgets into vision elements
        for m in messages_batch:
            for msg in m:
                if isinstance(msg.get("content"), list):
                    for ele in msg["content"]:
                        if "video" in ele or "image" in ele:
                            if min_pixels or self.min_pixels:
                                ele.setdefault(
                                    "min_pixels", min_pixels or self.min_pixels
                                )
                            if max_pixels or self.max_pixels:
                                ele.setdefault(
                                    "max_pixels", max_pixels or self.max_pixels
                                )
        images, videos, vkw = process_vision_info(
            list(messages_batch), return_video_kwargs=True, device=self.device
        )
        return self(
            texts, images=images, videos=videos, fps=vkw.get("fps"),
        )


def pack_vision_inputs(enc: dict):
    """Processor output -> (packed pixel patches, flat grid tuple) in media
    APPEARANCE order (the order merge_vision_embeds scatters placeholder
    tokens in). Handles video-only, image-only and MIXED batches — the
    reference gets this ordering implicitly from the HF processor's
    masked_scatter contract.

    Returns (None, None) when the batch has no media.
    """
    has_v = "video_grid_thw" in enc
    has_i = "image_grid_thw" in enc
    if not has_v and not has_i:
        return None, None
    if has_v and not has_i:
        grids = tuple(tuple(int(x) for x in g) for g in enc["video_grid_thw"])
        return enc["pixel_values_videos"], grids
    if has_i and not has_v:
        grids = tuple(tuple(int(x) for x in g) for g in enc["image_grid_thw"])
        return enc["pixel_values"], grids

    order = enc.get("media_order")
    if order is None:
        raise ValueError(
            "mixed image+video batch requires media_order (VLProcessor "
            "output) to establish the placeholder appearance order"
        )
    vgrids = np.asarray(enc["video_grid_thw"])
    igrids = np.asarray(enc["image_grid_thw"])
    voff = np.concatenate([[0], np.cumsum(vgrids.prod(axis=1))])
    ioff = np.concatenate([[0], np.cumsum(igrids.prod(axis=1))])
    parts, grids = [], []
    for kind, k in order:
        if kind == "video":
            parts.append(
                enc["pixel_values_videos"][voff[k] : voff[k + 1]]
            )
            grids.append(tuple(int(x) for x in vgrids[k]))
        else:
            parts.append(enc["pixel_values"][ioff[k] : ioff[k + 1]])
            grids.append(tuple(int(x) for x in igrids[k]))
    return np.concatenate(parts, axis=0), tuple(grids)
