"""Image/video -> model-ready tensors (counterpart of spacer_tpu/vision/process.py).

Decode stays on the host (vision/reader.py); resize + normalize + patchify
run in PyTorch on an explicit device.  The antialiased bicubic resize is two
dense matmuls with weight matrices built in numpy by the formula JAX's
`jax.image.resize(method="bicubic", antialias=True)` uses (Keys cubic,
a = -0.5, support widened by the downscale factor), so pixel values agree
with the JAX package.  PIL is imported only on the PIL-image path and cv2
only on the video-file path.
"""

from __future__ import annotations

import base64
from io import BytesIO

import numpy as np
import torch

from spacer_tpu_torch.vision.smart import (
    FPS,
    FRAME_FACTOR,
    IMAGE_FACTOR,
    MAX_PIXELS,
    MIN_PIXELS,
    ceil_by_factor,
    smart_resize,
    video_frame_pixel_budget,
)

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

PATCH_SIZE = 14
TEMPORAL_PATCH_SIZE = 2
MERGE_SIZE = 2


def patchify_frames(frames):
    """(T, C, H, W) normalized frames -> ((grid_t*grid_h*grid_w, C*2*14*14),
    grid), in the HF Qwen2VL image processor's flatten order."""
    T, C, H, W = frames.shape
    tp, p, m = TEMPORAL_PATCH_SIZE, PATCH_SIZE, MERGE_SIZE
    if T % tp:
        frames = torch.cat([frames] + [frames[-1:]] * (tp - T % tp))
        T = frames.shape[0]
    gt, gh, gw = T // tp, H // p, W // p
    patches = frames.reshape(gt, tp, C, gh // m, m, p, gw // m, m, p)
    patches = patches.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return patches.reshape(gt * gh * gw, C * tp * p * p), (gt, gh, gw)


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f32 antialiased bicubic resize matrix, the weights
    of jax.image.resize(..., method="bicubic", antialias=True) computed in
    float32 as JAX computes them."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32).T.copy()


def resize_frames(frames, out_h: int, out_w: int, device="cpu"):
    """(T, H, W, C) frames in [0, 255] -> (T, out_h, out_w, C) f32 torch
    tensor on `device`, antialiased bicubic (see bicubic_weights)."""
    x = torch.tensor(np.asarray(frames), dtype=torch.float32, device=device)
    in_h, in_w = x.shape[1], x.shape[2]
    if (in_h, in_w) != (out_h, out_w):
        wh = torch.from_numpy(bicubic_weights(in_h, out_h)).to(device)
        ww = torch.from_numpy(bicubic_weights(in_w, out_w)).to(device)
        x = torch.einsum("hj,tjwc->thwc", wh, x)
        x = torch.einsum("wk,thkc->thwc", ww, x)
    return x


def _resize_normalize_patchify(frames, out_h: int, out_w: int, device="cpu"):
    """(T, H, W, C) uint8/float frames -> (N, patch_dim) f32 on `device`."""
    x = resize_frames(frames, out_h, out_w, device) * (1.0 / 255.0)
    mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(OPENAI_CLIP_STD, dtype=torch.float32, device=device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    flat, _ = patchify_frames(x)
    return flat


def preprocess_frames(frames: np.ndarray, min_pixels: int | None = None,
                      max_pixels: float | None = None,
                      resized_hw: tuple[int, int] | None = None,
                      device="cpu"):
    """(T, H, W, C) uint8 frames -> (pixel_values (N, patch_dim) f32 numpy,
    grid_thw).  `resized_hw` pins the target resolution (else smart_resize
    decides); the pixel pipeline runs on `device`."""
    if frames.ndim != 4:
        raise ValueError(f"expected (T, H, W, C) frames, got {frames.shape}")
    T, H, W, _ = frames.shape
    if resized_hw is None:
        resized_hw = smart_resize(
            H, W, factor=PATCH_SIZE * MERGE_SIZE,
            min_pixels=min_pixels if min_pixels is not None else MIN_PIXELS,
            max_pixels=max_pixels if max_pixels is not None else MAX_PIXELS,
        )
    out_h, out_w = resized_hw
    grid = (ceil_by_factor(T, TEMPORAL_PATCH_SIZE) // TEMPORAL_PATCH_SIZE,
            out_h // PATCH_SIZE, out_w // PATCH_SIZE)
    flat = _resize_normalize_patchify(frames, out_h, out_w, device)
    return flat.cpu().numpy(), grid


# ---------------------------------------------------------------------------
# fetch_image / fetch_video / process_vision_info
# ---------------------------------------------------------------------------


def _to_rgb(pil_image):
    from PIL import Image

    if pil_image.mode == "RGBA":
        bg = Image.new("RGB", pil_image.size, (255, 255, 255))
        bg.paste(pil_image, mask=pil_image.split()[3])
        return bg
    return pil_image.convert("RGB")


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR):
    """Load + smart-resize one image (PIL object, local path, file:// or
    base64 data URI) -> PIL.Image."""
    from PIL import Image

    image = ele.get("image", ele.get("image_url"))
    if hasattr(image, "convert"):
        image_obj = image
    elif isinstance(image, str) and image.startswith("file://"):
        image_obj = Image.open(image[7:])
    elif isinstance(image, str) and image.startswith("data:image"):
        if "base64," not in image:
            raise ValueError(f"unsupported data URI: {image[:40]}")
        image_obj = Image.open(BytesIO(base64.b64decode(image.split("base64,", 1)[1])))
    elif isinstance(image, str) and not image.startswith(("http://", "https://")):
        image_obj = Image.open(image)
    else:
        raise ValueError(f"unsupported image input: {type(image)} "
                         "(remote URLs are not fetched)")
    image_obj = _to_rgb(image_obj)
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(ele["resized_height"], ele["resized_width"],
                              factor=size_factor)
    else:
        w, h = image_obj.size
        rh, rw = smart_resize(h, w, factor=size_factor,
                              min_pixels=ele.get("min_pixels", MIN_PIXELS),
                              max_pixels=ele.get("max_pixels", MAX_PIXELS))
    return image_obj.resize((rw, rh))


def _resize_video(frames: np.ndarray, ele: dict, image_factor: int,
                  device="cpu") -> np.ndarray:
    """Sampled (T, H, W, C) frames -> (T, C, rh, rw) f32 at the per-frame
    video pixel budget."""
    nframes, height, width = frames.shape[:3]
    min_pixels, max_pixels = video_frame_pixel_budget(
        nframes, min_pixels=ele.get("min_pixels"),
        total_pixels=ele.get("total_pixels"),
        max_pixels_supposed=ele.get("max_pixels"),
    )
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(ele["resized_height"], ele["resized_width"],
                              factor=image_factor)
    else:
        rh, rw = smart_resize(height, width, factor=image_factor,
                              min_pixels=min_pixels, max_pixels=max_pixels)
    x = resize_frames(frames, rh, rw, device)
    return x.permute(0, 3, 1, 2).cpu().numpy()


def fetch_video(ele: dict, image_factor: int = IMAGE_FACTOR,
                return_video_sample_fps: bool = False, device="cpu"):
    """Decode + sample + resize a video.

    `ele["video"]` is a file path (decoded and sampled by vision/reader.py),
    a (T, H, W, C) uint8 array of already-sampled frames, or a list of PIL
    frames.  Paths and arrays give (T, C, H, W) f32 frames at the video
    pixel budget; a list gives the padded list of resized PIL frames."""
    video = ele["video"]
    if isinstance(video, (str, np.ndarray)):
        if isinstance(video, str):
            from spacer_tpu_torch.vision.reader import read_video

            frames, sample_fps = read_video(ele)
        else:
            if video.ndim != 4:
                raise ValueError(f"expected (T, H, W, C) frames, got {video.shape}")
            frames, sample_fps = video, float(ele.get("fps", FPS))
        out = _resize_video(frames, ele, image_factor, device)
        return (out, sample_fps) if return_video_sample_fps else out
    if not isinstance(video, (list, tuple)):
        raise ValueError(f"unsupported video input: {type(video)}")
    info = {k: v for k, v in ele.items() if k not in ("type", "video")}
    images = [
        fetch_image({"image": el, **{k: v for k, v in info.items() if k != "fps"}},
                    size_factor=image_factor)
        for el in video
    ]
    nframes = ceil_by_factor(len(images), FRAME_FACTOR)
    images.extend([images[-1]] * (nframes - len(images)))
    if return_video_sample_fps:
        return images, info.get("fps", 2.0)
    return images


def extract_vision_info(conversations):
    infos = []
    if conversations and isinstance(conversations[0], dict):
        conversations = [conversations]
    for conversation in conversations:
        for message in conversation:
            if isinstance(message.get("content"), list):
                for ele in message["content"]:
                    if ("image" in ele or "image_url" in ele or "video" in ele
                            or ele.get("type") in ("image", "image_url", "video")):
                        infos.append(ele)
    return infos


def process_vision_info(conversations, return_video_kwargs: bool = False,
                        device="cpu"):
    """Walk conversation content; load all images/videos ->
    (images | None, videos | None[, {'fps': [...]}])."""
    image_inputs, video_inputs, fps_list = [], [], []
    for info in extract_vision_info(conversations):
        if "image" in info or "image_url" in info:
            image_inputs.append(fetch_image(info))
        elif "video" in info:
            video, fps = fetch_video(info, return_video_sample_fps=True,
                                     device=device)
            video_inputs.append(video)
            fps_list.append(fps)
        else:
            raise ValueError("image, image_url or video should be in content.")
    image_inputs = image_inputs or None
    video_inputs = video_inputs or None
    if return_video_kwargs:
        return image_inputs, video_inputs, {"fps": fps_list}
    return image_inputs, video_inputs
