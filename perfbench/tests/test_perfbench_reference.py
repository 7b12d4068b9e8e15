"""The plain references against the port's own functions at tiny sizes on
the CPU, in float32 (the references import nothing of the port; these tests
do, to hold them against it)."""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import tiny  # noqa: E402
from harness import weights  # noqa: E402
from harness.serving import port_config  # noqa: E402
from reference import aria, qwen25_vl  # noqa: E402
from reference.common import Precision  # noqa: E402

CPU = torch.device("cpu")
QCFG = {"family": "qwen25_vl", "model": tiny.QWEN}
ACFG = {"family": "aria", "model": tiny.ARIA, "assumed": {"router_logit_std": 3.0}}


def qwen_params(seed=0):
    return weights.make("qwen25_vl", tiny.QWEN, {}, seed, CPU, torch.float32)


def test_vit_against_the_port():
    from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout, vit_forward

    cfg = port_config(QCFG)
    params = qwen_params()
    for grid in ((2, 4, 6), (3, 8, 10), (1, 10, 4)):
        px = torch.randn(grid[0] * grid[1] * grid[2], 1176, generator=torch.Generator().manual_seed(1))
        want = vit_forward(params["visual"], cfg.vision, px, vision_layout([grid], cfg.vision))
        got = qwen25_vl.vision_encode(params["visual"], tiny.QWEN["vision_config"], px, grid,
                                      Precision("f32"))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_qwen_lm_and_positions_against_the_port():
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.models.qwen25_vl.model import encode_vision, merge_vision_embeds
    from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

    cfg = port_config(QCFG)
    params = qwen_params(3)
    grid = (2, 4, 6)
    ids = np.concatenate([[11, 12, 4], [7] * 12, [5], np.arange(20, 31)]).astype(np.int64)
    served = np.array([40, 41, 42, 43], np.int64)
    px = torch.randn(48, 1176, generator=torch.Generator().manual_seed(2))
    toks = np.concatenate([ids, served[:-1]])
    pos, _ = get_rope_index(cfg, toks[None], video_grid_thw=np.array([grid]),
                            second_per_grid_ts=np.array([1.0]))
    t = torch.as_tensor(toks)[None]
    x = merge_vision_embeds(cfg, t, params["model"]["embed_tokens"]["embedding"][t],
                            encode_vision(params, cfg, px, [grid]))
    want, _ = lm_forward(params["model"], cfg.text, input_embeds=x,
                         position_ids=torch.as_tensor(pos))
    assert np.array_equal(qwen25_vl.mrope_positions(ids, grid, tiny.QWEN, 1.0, len(toks)),
                          pos[:, 0])
    got = qwen25_vl.served_logits(params, tiny.QWEN, [{"ids": ids, "pixels": px, "grid": grid,
                                                        "second_per_grid": 1.0,
                                                        "served": served}], Precision("f32"))[0]
    torch.testing.assert_close(got, want[0, -4:], rtol=1e-4, atol=1e-4)


def test_aria_lm_with_its_moe_against_the_port():
    from spacer_tpu_torch.models.aria.language import lm_forward, positions_1d_to_3d

    cfg = port_config(ACFG)
    params = weights.make("aria", tiny.ARIA, ACFG["assumed"], 4, CPU, torch.float32)
    ids = np.arange(10, 60, dtype=np.int64)
    served = np.array([70, 71, 72], np.int64)
    toks = torch.as_tensor(np.concatenate([ids, served[:-1]]))[None]
    pos = positions_1d_to_3d(torch.arange(toks.shape[1])[None])
    want, _ = lm_forward(params["model"], cfg.text, input_ids=toks, position_ids=pos)
    got = aria.served_logits(params, tiny.ARIA, [{"ids": ids, "served": served}],
                             Precision("f32"))[0]
    torch.testing.assert_close(got, want[0, -3:], rtol=1e-4, atol=1e-4)


def test_gap_is_zero_for_the_best_token_and_positive_otherwise():
    from reference.common import gaps

    lg = torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 0.5]])
    assert gaps(lg, torch.tensor([1, 2])).tolist() == [0.0, 2.5]
