"""The port's Aria processor (spacer_tpu_torch.data.aria_processor) against
spacer_tpu's on the same uint8 images and messages: every output array
equal (the two run the same numpy and PIL code, so bitwise), at ARIA_25B's
geometry (980-pixel crops, one of them padded) and with split_image (the
best-resolution crops and the batch-max crop expansion, the HF quirk that
expands every image token by the largest crop count), plus the chat
template, the best-resolution rule and the mock tokenizer.
"""

import numpy as np
import pytest

from spacer_tpu.data import aria_processor as jap
from spacer_tpu.models.aria.config import ARIA_25B as JAX_ARIA_25B
from spacer_tpu_torch.data import aria_processor as ap
from spacer_tpu_torch.models.aria import ARIA_25B


def _messages(images):
    return [[{"role": "user", "content": [
        {"type": "image", "image": img},
        {"type": "text", "text": f"what is in picture {i}"}]}]
        for i, img in enumerate(images)]


def _assert_same(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("split_image", [False, True])
def test_process_messages_matches_jax(split_image):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (720, 1280, 3), np.uint8),
              rng.integers(0, 256, (300, 500, 3), np.uint8)]
    # split: 490-pixel crops, 6 of the first image and 2 of the second, so
    # both rows expand by the batch max
    size = 490 if split_image else 980
    kw = dict(max_image_size=size, split_image=split_image)
    proc = ap.AriaProcessor(ap.MockAriaTokenizer(), ARIA_25B, **kw)
    ref_proc = jap.AriaProcessor(jap.MockAriaTokenizer(), JAX_ARIA_25B, **kw)
    msgs = _messages(images)
    got, ref = proc.process_messages(msgs), ref_proc.process_messages(msgs)
    _assert_same(got, ref)
    assert got["pixel_values"].shape[1:] == (size, size, 3)
    assert got["num_crops"] == (6 if split_image else 1)
    # every image row carries num_crops x queries placeholder tokens
    n_img = int((got["input_ids"] == ap.MockAriaTokenizer.SPECIALS[
        ap.IMG_TOKEN]).sum())
    assert n_img == (len(images) * got["num_crops"]
                     * ap.SIZE_CONVERSION[size])
    # a whole image's crop pads its short side, which the patch mask masks
    assert split_image or not got["patch_mask"].all()


def test_text_rows_template_and_rules_match_jax():
    msgs = [[{"role": "system", "content": "be brief"},
             {"role": "user", "content": "hello there"}],
            [{"role": "user", "content": [{"type": "text", "text": "hi"}]}]]
    tok, ref_tok = ap.MockAriaTokenizer(512), jap.MockAriaTokenizer(512)
    _assert_same(ap.AriaProcessor(tok).process_messages(msgs),
                 jap.AriaProcessor(ref_tok).process_messages(msgs))
    for m in msgs:
        assert (ap.render_aria_chat_template(m)
                == jap.render_aria_chat_template(m))
    for size in ((300, 500), (1000, 200), (980, 980), (64, 2000)):
        assert (ap.select_best_resolution(size, ap.SPLIT_RESOLUTIONS)
                == jap.select_best_resolution(size, jap.SPLIT_RESOLUTIONS))
    ids = tok.encode("<|im_start|>user\n<fim_prefix><|img|> a b")
    assert ids == ref_tok.encode("<|im_start|>user\n<fim_prefix><|img|> a b")
    assert tok.decode(ids) == ref_tok.decode(ids)
