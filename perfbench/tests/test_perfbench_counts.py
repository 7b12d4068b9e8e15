"""Each count against a shape worked by hand."""

from __future__ import annotations

import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from counts import kernels, models  # noqa: E402
from yardstick import causal_pairs, roofline  # noqa: E402

QWEN = json.loads((BENCH / "configs/qwen25vl7b.json").read_text())
ARIA = json.loads((BENCH / "configs/aria25b.json").read_text())
VC = QWEN["model"]["vision_config"]


def test_yardstick():
    assert causal_pairs([3, 5]) == 6 + 15
    r = roofline(3.35e12, 989e12 / 2)
    assert r["bound_ms"] == 1000.0 and r["bound_by"] == "bytes"
    assert roofline(0, 989e12)["bound_by"] == "operations"


def test_k1_causal_and_padded():
    # rows of 3 and 5 real tokens (padding not counted): 6 + 15 pairs;
    # 2 heads of 4 over 1 KV head: 4 x 21 x 2 x 4 operations; q, o of 8
    # rows x 2 heads and k, v of 8 rows x 1 head, 4 bf16 values each
    assert kernels.k1_prefill([3, 5], 2, 1, 4) == (2 * 4 * (2 * 8 * 2 + 2 * 8 * 1),
                                                   4 * 21 * 2 * 4)


def test_k3_k4_at_a_16_frame_video():
    # grid (8, 16, 30): per frame chunk 8 x 15 merge units in windows of
    # 4 x 4 units: columns of 4, 4, 4, 3 units in two rows, so windows of
    # 64, 64, 64, 48 tokens twice
    assert kernels.vit_windows((8, 16, 30), 112, 14, 2) == [64, 64, 64, 48] * 2 * 8
    pairs_k3 = 8 * 2 * (3 * 64 * 64 + 48 * 48)
    assert kernels.k3_vit((8, 16, 30), VC)[1] == 28 * 4 * pairs_k3 * 16 * 80
    # full blocks: 8 chunks of 480 tokens
    assert kernels.k4_vit((8, 16, 30), VC)[1] == 4 * 4 * 8 * 480 * 480 * 16 * 80
    assert kernels.k4_vit((8, 16, 30), VC)[0] == 4 * 2 * 80 * 4 * 3840 * 16


def test_k5_and_grouped_mm():
    # a slot with a 10-token prompt, steps 1-3: 11 + 12 + 13 keys
    b, o = kernels.k5_steps(10, 3, 28, 4, 128)
    assert o == 4 * 36 * 28 * 128 and b == 2 * 128 * (2 * 3 * 28 + 2 * 36 * 4)
    assert kernels.k5_steps(10, 2, 28, 4, 128, first=2)[1] == 4 * (12 + 13) * 28 * 128
    assert kernels.grouped_mm(6, 2560, 1664) == 2 * 6 * (2560 * 3328 + 1664 * 2560)
    assert kernels.expert_bytes(6, 2560, 1664) == 2 * 6 * (2560 * 3328 + 1664 * 2560)


def test_step_operations_of_each_configuration():
    # Qwen2.5-VL-7B, a layer: q 3584 x 3584, k and v 3584 x 512, o 3584 x
    # 3584, gate / up / down 3584 x 18944
    qwen_layer = 3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944
    assert models.layer_matmul_weights(models.lm_dims(QWEN)) == qwen_layer == 233_046_016
    # a 2-token prompt: 28 layers of 2 tokens' products and 3 pairs of 28
    # heads of 128, then one row of the 3584 x 152064 head
    assert models.prefill(QWEN, 2) == 28 * (2 * 2 * qwen_layer + 4 * 3 * 28 * 128) \
        + 2 * 3584 * 152064
    # Aria, a layer: q / k / v / o 2560 x 2560, router 2560 x 64, 6 experts of
    # 2560 -> 3328 -> 2560, shared 2560 -> 6656 -> 2560
    aria_layer = 4 * 2560 * 2560 + 2560 * 64 + 6 * 3 * 2560 * 1664 + 3 * 2560 * 3328
    assert models.layer_matmul_weights(models.lm_dims(ARIA)) == aria_layer == 128_614_400
    # decode steps 1-2 after a 4-token prompt: 5 + 6 keys, 2 heads
    assert models.decode(ARIA, 4, 2) == 28 * (2 * 2 * aria_layer + 4 * 11 * 20 * 128) \
        + 2 * 2 * 2560 * 100352
    # the ViT at (1, 2, 2): 4 patches, one window and one chunk of 4
    d, i = 1280, 3420
    vit = (2 * 4 * 1176 * d + 2 * 4 * 32 * (4 * d * d + 3 * d * i)
           + 4 * 16 * 16 * 80 * 32 + 2 * 1 * (5120 * 5120 + 5120 * 3584))
    assert models.vit(QWEN, (1, 2, 2)) == vit
