"""Video/image preprocessing with qwen-vl-utils parity semantics (counterpart
of spacer_tpu/vision): host decode, then resize + normalize + patchify in
PyTorch."""

from spacer_tpu_torch.vision.process import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    fetch_image,
    fetch_video,
    patchify_frames,
    preprocess_frames,
    process_vision_info,
)
from spacer_tpu_torch.vision.smart import smart_nframes, smart_resize

__all__ = [
    "OPENAI_CLIP_MEAN", "OPENAI_CLIP_STD", "fetch_image", "fetch_video",
    "patchify_frames", "preprocess_frames", "process_vision_info",
    "smart_nframes", "smart_resize",
]
