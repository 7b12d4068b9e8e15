# Copied from spacer_tpu/models/qwen25_vl/rope_index.py; only its imports point at spacer_tpu_torch.
"""3D (temporal/height/width) rope position ids for mixed text+vision input.

Behavioral reference: modeling_qwen2_5_vl.py get_rope_index (:956-1141),
including the temporal stride `second_per_grid_t * tokens_per_second` and the
text-continues-after-max rule.  Pure numpy — position ids depend only on
token ids and grids, so they are precomputed host-side per batch and shipped
to the device with the ids.
"""

from __future__ import annotations

import numpy as np

from spacer_tpu_torch.models.qwen25_vl.config import Qwen25VLConfig


def get_rope_index(
    cfg: Qwen25VLConfig,
    input_ids: np.ndarray,                 # (B, S) int
    image_grid_thw: np.ndarray | None = None,   # (n_images, 3)
    video_grid_thw: np.ndarray | None = None,   # (n_videos, 3)
    second_per_grid_ts: np.ndarray | None = None,  # (n_videos,)
    attention_mask: np.ndarray | None = None,   # (B, S) 1=real
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (position_ids (3, B, S), mrope_position_deltas (B, 1))."""
    input_ids = np.asarray(input_ids)
    B, S = input_ids.shape
    merge = cfg.vision.spatial_merge_size
    tps = cfg.vision.tokens_per_second

    has_vision = (image_grid_thw is not None and len(image_grid_thw) > 0) or (
        video_grid_thw is not None and len(video_grid_thw) > 0
    )
    if not has_vision:
        if attention_mask is not None:
            pos = np.cumsum(attention_mask, axis=-1) - 1
            pos[attention_mask == 0] = 1
            position_ids = np.broadcast_to(pos[None], (3, B, S)).copy()
            deltas = (pos.max(axis=-1, keepdims=True) + 1) - S
        else:
            position_ids = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
            deltas = np.zeros((B, 1), dtype=np.int64)
        return position_ids.astype(np.int64), deltas.astype(np.int64)

    position_ids = np.ones((3, B, S), dtype=np.int64)
    deltas = []
    image_index, video_index = 0, 0
    for i in range(B):
        ids = input_ids[i]
        if attention_mask is not None:
            keep = attention_mask[i] == 1
            ids = ids[keep]
        tokens = ids.tolist()
        vision_starts = np.where(ids == cfg.vision_start_token_id)[0]
        next_tok = ids[vision_starts + 1] if len(vision_starts) else np.array([])
        n_images = int((next_tok == cfg.image_token_id).sum())
        n_videos = int((next_tok == cfg.video_token_id).sum())
        pos_list = []
        st = 0
        remain_images, remain_videos = n_images, n_videos
        for _ in range(n_images + n_videos):
            ed_image = (
                tokens.index(cfg.image_token_id, st)
                if cfg.image_token_id in tokens[st:] and remain_images > 0
                else len(tokens) + 1
            )
            ed_video = (
                tokens.index(cfg.video_token_id, st)
                if cfg.video_token_id in tokens[st:] and remain_videos > 0
                else len(tokens) + 1
            )
            if ed_image < ed_video:
                t, h, w = image_grid_thw[image_index]
                second_per_grid_t = 0.0
                image_index += 1
                remain_images -= 1
                ed = ed_image
            else:
                t, h, w = video_grid_thw[video_index]
                second_per_grid_t = (
                    float(second_per_grid_ts[video_index])
                    if second_per_grid_ts is not None
                    else 1.0
                )
                video_index += 1
                remain_videos -= 1
                ed = ed_video
            lt, lh, lw = int(t), int(h) // merge, int(w) // merge
            text_len = ed - st
            st_idx = (pos_list[-1].max() + 1) if pos_list else 0
            pos_list.append(
                np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx
            )
            t_index = (
                (np.arange(lt)[:, None] * second_per_grid_t * tps)
                .astype(np.int64)
                .repeat(lh * lw, axis=1)
                .flatten()
            )
            h_index = np.tile(np.arange(lh)[None, :, None], (lt, 1, lw)).flatten()
            w_index = np.tile(np.arange(lw)[None, None, :], (lt, lh, 1)).flatten()
            pos_list.append(
                np.stack([t_index, h_index, w_index]) + text_len + st_idx
            )
            st = ed + lt * lh * lw
        if st < len(tokens):
            st_idx = (pos_list[-1].max() + 1) if pos_list else 0
            text_len = len(tokens) - st
            pos_list.append(
                np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx
            )
        llm_positions = np.concatenate(pos_list, axis=1).reshape(3, -1)
        if attention_mask is not None:
            position_ids[:, i, attention_mask[i] == 1] = llm_positions
        else:
            position_ids[:, i, :] = llm_positions
        deltas.append(llm_positions.max() + 1 - S)
    return position_ids, np.asarray(deltas, dtype=np.int64)[:, None]
