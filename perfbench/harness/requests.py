"""Prompt inputs made by the benchmark from the seed, for one deck of
request shapes (harness/traffic.py): token ids, and for a video the packed
pixel patches and their grid.  Both sides get these same inputs; what the
program derives from them (positions, padding, the vision encoding) each
side works out itself.

A traffic file's "prompt" says which kind:
- "video_question": chat-like text (`prefix_tokens`), one video's
  placeholders between the vision start and end ids, the question
  (`question_tokens` of the deck), then `suffix_tokens`; the video has
  `video_frames` of the deck, packed as (frames / temporal patch,
  grid_h, grid_w) patches (`grid_hw`: what the processor gives the stated
  frame size) at `fps`;
- "document": `prompt_tokens` of the deck, plain text.
Text ids are drawn from the configuration's `text_ids` range; pixel patches
are standard normals, as the processor's normalized pixels roughly are,
drawn on the device in one call for the whole deck.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.traffic import rng


def _text(r: np.random.Generator, lo_hi, n: int) -> np.ndarray:
    return r.integers(lo_hi[0], lo_hi[1], n, dtype=np.int64)


def video_question(config: dict, prompt: dict, shapes: list, seed: int,
                   device, dtype=torch.bfloat16) -> list[dict]:
    """-> per shape {"ids", "pixels", "grid", "second_per_grid"}."""
    model = config["model"]
    vc = model["vision_config"]
    tp = vc["temporal_patch_size"]
    gh, gw = prompt["grid_hw"]
    m2 = vc["spatial_merge_size"] ** 2
    patch_dim = 3 * tp * vc["patch_size"] ** 2
    grids = [(s["video_frames"] // tp, gh, gw) for s in shapes]
    counts = [t * h * w for t, h, w in grids]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty((sum(counts), patch_dim), dtype=dtype, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    out, start = [], 0
    for i, (s, grid, n) in enumerate(zip(shapes, grids, counts)):
        r = rng(seed, 3, i)
        ids = np.concatenate([
            _text(r, config["text_ids"], prompt["prefix_tokens"]),
            [model["vision_start_token_id"]],
            np.full(n // m2, model["video_token_id"]),
            [model["vision_end_token_id"]],
            _text(r, config["text_ids"], s["question_tokens"]),
            _text(r, config["text_ids"], prompt["suffix_tokens"])]).astype(np.int64)
        out.append({"ids": ids, "pixels": flat[start:start + n], "grid": grid,
                    "second_per_grid": tp / prompt["fps"]})
        start += n
    return out


def document(config: dict, prompt: dict, shapes: list, seed: int, device,
             dtype=torch.bfloat16) -> list[dict]:
    return [{"ids": _text(rng(seed, 3, i), config["text_ids"], s["prompt_tokens"]),
             "pixels": None, "grid": None} for i, s in enumerate(shapes)]


KINDS = {"video_question": video_question, "document": document}


def build(config: dict, prompt: dict, shapes: list, seed: int, device) -> list[dict]:
    return KINDS[prompt["kind"]](config, prompt, shapes, seed, device)
