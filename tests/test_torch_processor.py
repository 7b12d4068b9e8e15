"""Processor parity: spacer_tpu_torch preprocess_frames / VLProcessor against
spacer_tpu on frame arrays, PIL frames and an mp4 file written with cv2.

Token ids and grids must be identical.  Pixel values within 1e-4 abs: both
sides resize with the same antialiased bicubic weights in float32 (the port
builds them in numpy by JAX's formula) and differ only in summation order.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spacer_tpu.data.processor import MockTokenizer as JaxTokenizer
from spacer_tpu.data.processor import VLProcessor as JaxProcessor
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.vision.process import preprocess_frames as jax_preprocess
from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
from spacer_tpu_torch.vision.process import fetch_video, preprocess_frames

PX_TOL = dict(atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,resized", [((3, 60, 80, 3), None),
                                          ((4, 90, 50, 3), (56, 28)),
                                          ((2, 56, 84, 3), None)])
def test_preprocess_frames_matches_jax(shape, resized):
    frames = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    px, grid = preprocess_frames(frames, resized_hw=resized)
    jpx, jgrid = jax_preprocess(frames, resized_hw=resized)
    assert grid == jgrid
    np.testing.assert_allclose(px, np.asarray(jpx), **PX_TOL)


def _compare(enc, jenc):
    assert sorted(enc) == sorted(jenc)
    for key in enc:
        if key.startswith("pixel_values"):
            np.testing.assert_allclose(enc[key], jenc[key], **PX_TOL)
        else:
            np.testing.assert_array_equal(np.asarray(enc[key]),
                                          np.asarray(jenc[key]), err_msg=key)


def _processors():
    cfg = tiny_config()
    return (VLProcessor(MockTokenizer(cfg.text.vocab_size), cfg),
            JaxProcessor(JaxTokenizer(cfg.text.vocab_size), cfg))


def test_processor_pil_frames_and_image_match_jax():
    from PIL import Image

    rng = np.random.default_rng(1)
    vid = [Image.fromarray(rng.integers(0, 256, (70, 90, 3), np.uint8))
           for _ in range(3)]
    img = Image.fromarray(rng.integers(0, 256, (84, 56, 3), np.uint8))
    msgs = [
        [{"role": "user", "content": [
            {"type": "video", "video": vid},
            {"type": "text", "text": "what happens"}]}],
        [{"role": "user", "content": [
            {"type": "image", "image": img},
            {"type": "text", "text": "describe the picture please"}]}],
    ]
    proc, jproc = _processors()
    enc = proc.process_messages(copy.deepcopy(msgs))
    jenc = jproc.process_messages(copy.deepcopy(msgs))
    _compare(enc, jenc)


def test_processor_mp4_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (96, 64))
    rng = np.random.default_rng(2)
    for _ in range(20):
        writer.write(rng.integers(0, 256, (64, 96, 3), np.uint8))
    writer.release()
    msgs = [[{"role": "user", "content": [
        {"type": "video", "video": path},
        {"type": "text", "text": "how many objects"}]}]]
    proc, jproc = _processors()
    enc = proc.process_messages(copy.deepcopy(msgs))
    jenc = jproc.process_messages(copy.deepcopy(msgs))
    assert enc["video_grid_thw"].tolist() == [[2, 20, 28]]   # 4 frames, upsized
    _compare(enc, jenc)


def test_frame_array_video_matches_jax_resize():
    """A (T, H, W, C) uint8 frame array in the message (the port's input for
    already-sampled frames) is resized as JAX resizes decoded frames.
    Tolerance 4e-3 on the [0, 255] scale, i.e. 6e-5 after normalization."""
    frames = np.random.default_rng(3).integers(0, 256, (4, 64, 96, 3), np.uint8)
    video, fps = fetch_video({"video": frames, "fps": 2.0},
                             return_video_sample_fps=True)
    assert fps == 2.0 and video.shape[:2] == (4, 3)
    ref = jax.image.resize(jnp.asarray(frames, jnp.float32),
                           (4, video.shape[2], video.shape[3], 3),
                           method="bicubic", antialias=True)
    np.testing.assert_allclose(video, np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=4e-3, rtol=0)
