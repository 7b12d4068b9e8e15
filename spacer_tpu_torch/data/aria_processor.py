"""Aria processor: image preprocessing + chat template + token expansion
(counterpart of spacer_tpu/data/aria_processor.py; numpy and PIL only).

Behavioral reference: transformers processing_aria.py AriaProcessor
(image-token expansion by num_crops * tokens_per_image, size_conversion
{490: 128, 980: 256}) and image_processing_aria.py AriaImageProcessor
(keep-aspect resize to max_image_size on the long side with a
min_image_size floor, bottom/right zero padding, a boolean pixel mask,
optional best-resolution split into crops; select_best_resolution is the
llava-next rule).

The model-facing extras (`pixel_position_ids`, `patch_mask`) are computed
here on the host: the NaViT bucketed position ids that HF's vision tower
derives per batch row (models/aria/vision.py vision_position_ids).
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np

from spacer_tpu_torch.models.aria.config import AriaConfig
from spacer_tpu_torch.models.aria.vision import vision_position_ids

IMG_TOKEN = "<|img|>"
FIM_PREFIX = "<fim_prefix>"
FIM_SUFFIX = "<fim_suffix>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

# max_image_size -> learned queries per crop (AriaProcessor size_conversion)
SIZE_CONVERSION = {490: 128, 980: 256}

# AriaImageProcessor split_resolutions (multiples of 490)
SPLIT_RESOLUTIONS = [
    (el[0] * 490, el[1] * 490)
    for el in [(1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
               (2, 4), (2, 3), (2, 2), (2, 1), (3, 1), (3, 2), (4, 1),
               (4, 2), (5, 1), (6, 1), (7, 1), (8, 1)]
]


def select_best_resolution(size: tuple[int, int],
                           candidates: Sequence[tuple[int, int]]
                           ) -> tuple[int, int]:
    """llava-next rule: maximize effective resolution, then minimize waste."""
    oh, ow = size
    best, best_fit, min_waste = None, 0, float("inf")
    for h, w in candidates:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        waste = w * h - effective
        if effective > best_fit or (effective == best_fit and waste < min_waste):
            best_fit, min_waste, best = effective, waste, (h, w)
    return best


def _resize_bicubic(img: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """PIL bicubic resize (HF resample=BICUBIC numerics)."""
    from PIL import Image

    h, w = size_hw
    pil = Image.fromarray(img.astype(np.uint8))
    return np.asarray(pil.resize((w, h), Image.BICUBIC))


def _keep_ratio_size(h: int, w: int, max_size: int, min_size: int
                     ) -> tuple[int, int]:
    """New (h, w): long side -> max_size, short side floored at min_size."""
    scale = max_size / max(h, w)
    if w >= h:
        return max(int(h * scale), min_size), max_size
    return max_size, max(int(w * scale), min_size)


def _split_image_crops(img: np.ndarray, max_size: int) -> list[np.ndarray]:
    """Best-resolution resize + pad, then tile into max_size crops
    (AriaImageProcessor.get_image_patches)."""
    oh, ow = img.shape[:2]
    th, tw = select_best_resolution((oh, ow), SPLIT_RESOLUTIONS)
    scale = min(tw / ow, th / oh)
    nh, nw = min(int(oh * scale), th), min(int(ow * scale), tw)
    resized = _resize_bicubic(img, (nh, nw))
    pad_h, pad_w = th - nh, tw - nw
    padded = np.pad(resized, ((pad_h // 2, pad_h - pad_h // 2),
                              (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
    return [
        padded[i: i + max_size, j: j + max_size]
        for i in range(0, th, max_size)
        for j in range(0, tw, max_size)
    ]


def preprocess_aria_image(
    image, *, max_image_size: int = 980, min_image_size: int = 336,
    split_image: bool = False,
):
    """One image -> (pixel_values (N, S, S, 3) f32 in [-1, 1],
    pixel_mask (N, S, S) bool, num_crops N).

    Mirrors AriaImageProcessor.preprocess: per crop, keep-ratio resize to
    max_image_size on the long side, zero-pad bottom/right to a square,
    rescale 1/255 and normalize mean/std 0.5.  (The 490/980 restriction is
    enforced at the AriaProcessor level via its size_conversion map, which
    — like HF's constructor arg — tests may override for tiny geometries.)
    """
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    crops = (_split_image_crops(img, max_image_size) if split_image
             else [img])

    pixels, masks = [], []
    for crop in crops:
        h, w = crop.shape[:2]
        nh, nw = _keep_ratio_size(h, w, max_image_size, min_image_size)
        resized = _resize_bicubic(crop, (nh, nw)).astype(np.float32)
        canvas = np.zeros((max_image_size, max_image_size, 3), np.float32)
        canvas[:nh, :nw] = resized
        mask = np.zeros((max_image_size, max_image_size), bool)
        mask[:nh, :nw] = True
        pixels.append((canvas / 255.0 - 0.5) / 0.5)
        masks.append(mask)
    return np.stack(pixels), np.stack(masks), len(crops)


def patch_level_inputs(pixel_mask: np.ndarray, cfg: AriaConfig):
    """pixel_mask (N, S, S) -> (patch_mask (N, P), position_ids (N, P)).

    A patch is valid when any pixel in it is (AriaModel.
    _create_patch_attention_mask: unfold + sum > 0); position ids follow
    the NaViT bucketing over the valid sub-grid.
    """
    v = cfg.vision
    p = v.patch_size
    N, S, _ = pixel_mask.shape
    side = S // p
    grid = pixel_mask.reshape(N, side, p, side, p).sum(axis=(2, 4)) > 0
    patch_mask = grid.reshape(N, side * side)
    pos = np.zeros((N, side * side), np.int32)
    for i in range(N):
        nb_h = int(grid[i, :, 0].sum())
        nb_w = int(grid[i, 0, :].sum())
        pos[i] = vision_position_ids(nb_h, nb_w, v, max_h=side, max_w=side)
    return patch_mask, pos


def render_aria_chat_template(messages: Sequence[dict],
                              add_generation_prompt: bool = True) -> str:
    """Aria chat template (rhymes-ai/Aria chat_template.json semantics):
    image parts render as <fim_prefix><|img|><fim_suffix>; no implicit
    system message."""
    out = []
    for m in messages:
        content = m["content"]
        if isinstance(content, str):
            body = content
        else:
            parts = []
            for ele in content:
                t = ele.get("type")
                if t == "image" or "image" in ele or "image_url" in ele:
                    parts.append(FIM_PREFIX + IMG_TOKEN + FIM_SUFFIX)
                elif t == "text" or "text" in ele:
                    parts.append(ele.get("text", ""))
            body = "".join(parts)
        out.append(f"{IM_START}{m['role']}\n{body}{IM_END}\n")
    if add_generation_prompt:
        out.append(f"{IM_START}assistant\n")
    return "".join(out)


class MockAriaTokenizer:
    """Whitespace tokenizer with the Aria special tokens (tests/smoke)."""

    SPECIALS = {
        "<unk>": 0, "<s>": 1, "</s>": 2, "<fim_prefix>": 3,
        "<fim_suffix>": 4, "<|img|>": 9, "<|im_start|>": 5, "<|im_end|>": 6,
    }

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        self.eos_token_id = self.SPECIALS["</s>"]
        self.pad_token_id = self.SPECIALS["<unk>"]
        self.image_token = IMG_TOKEN
        self.image_token_id = self.SPECIALS[IMG_TOKEN]
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


class AriaProcessor:
    """text + images -> model-ready host arrays (HF AriaProcessor contract
    plus patch_mask / pixel_position_ids)."""

    def __init__(self, tokenizer, cfg: AriaConfig | None = None,
                 max_image_size: int = 980, min_image_size: int = 336,
                 split_image: bool = False,
                 size_conversion: dict[int, int] | None = None):
        self.tokenizer = tokenizer
        self.cfg = cfg or AriaConfig()
        self.max_image_size = max_image_size
        self.min_image_size = min_image_size
        self.split_image = split_image
        self.size_conversion = (
            dict(size_conversion) if size_conversion else dict(SIZE_CONVERSION)
        )
        if max_image_size not in self.size_conversion:
            raise ValueError(
                f"max_image_size {max_image_size} not in size_conversion "
                f"{sorted(self.size_conversion)}"
            )

    @property
    def eos_token_id(self):
        return self.tokenizer.eos_token_id

    @property
    def pad_token_id(self):
        pid = getattr(self.tokenizer, "pad_token_id", None)
        return pid if pid is not None else self.cfg.pad_token_id

    def apply_chat_template(self, messages, add_generation_prompt=True):
        return render_aria_chat_template(messages, add_generation_prompt)

    def __call__(self, text, images=None, padding_side: str = "left"):
        if isinstance(text, str):
            text = [text]
        images = list(images) if images else []

        pixel_list, mask_list, crops = [], [], []
        for im in images:
            px, mask, n = preprocess_aria_image(
                im, max_image_size=self.max_image_size,
                min_image_size=self.min_image_size,
                split_image=self.split_image,
            )
            pixel_list.append(px)
            mask_list.append(mask)
            crops.append(n)

        out: dict[str, Any] = {}
        if images:
            # HF quirk kept for parity (processing_aria.py:126-133): EVERY
            # image token expands by the batch-MAX crop count.
            num_crops = max(crops)
            tokens_per_image = self.size_conversion[self.max_image_size]
            expand = IMG_TOKEN * (num_crops * tokens_per_image)
            text = [t.replace(IMG_TOKEN, expand) for t in text]
            pixel_values = np.concatenate(pixel_list, axis=0)
            pixel_mask = np.concatenate(mask_list, axis=0)
            patch_mask, pos_ids = patch_level_inputs(pixel_mask, self.cfg)
            out.update(
                pixel_values=pixel_values.astype(np.float32),
                pixel_mask=pixel_mask,
                patch_mask=patch_mask,
                pixel_position_ids=pos_ids,
                num_crops=num_crops,
            )

        all_ids = [
            self.tokenizer.encode(t, add_special_tokens=False) for t in text
        ]
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
        out["input_ids"] = input_ids
        out["attention_mask"] = attention_mask
        return out

    def process_messages(self, messages_batch, add_generation_prompt=True):
        """Message lists (image elements carry arrays/paths/PIL) -> arrays."""
        texts = [
            self.apply_chat_template(m, add_generation_prompt)
            for m in messages_batch
        ]
        images = []
        for m in messages_batch:
            for msg in m:
                if isinstance(msg.get("content"), list):
                    for ele in msg["content"]:
                        if "image" in ele or ele.get("type") == "image":
                            images.append(_fetch_image(ele))
        return self(texts, images=images)


def _fetch_image(ele: dict):
    """Resolve an image element to a raw (H, W, C) array.

    Unlike the Qwen path (vision/process.py fetch_image), Aria does NOT
    smart-resize at fetch time — all geometry happens in
    preprocess_aria_image."""
    src = ele.get("image")
    if src is None:
        src = ele.get("image_url")
    if isinstance(src, np.ndarray):
        return src
    if hasattr(src, "convert"):  # PIL
        return np.asarray(src.convert("RGB"))
    if isinstance(src, str):
        from PIL import Image

        path = src[7:] if src.startswith("file://") else src
        return np.asarray(Image.open(path).convert("RGB"))
    raise ValueError(f"cannot resolve image element {type(src)}")
