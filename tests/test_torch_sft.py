"""SFT in spacer_tpu_torch against spacer_tpu (counterpart of
tests/test_train_step.py::test_sft_step and tests/test_cli.py::
test_train_sft_cli), tiny config, float32.

- `prepare_sft_example` builds the same messages, and `SFTTrainer.collate`
  the same batch: ids, labels with -100 on padding and the visual tokens,
  kv mask, M-RoPE positions and grids exactly (the same numpy code over
  the same MockTokenizer ids), the pixels to 1e-4 (the packages' bicubic
  resizes, as tests/test_torch_processor.py holds them);
- two SFT steps give JAX's loss (rtol 1e-5) and params (5e-6 absolute at
  learning rate 1e-3; Adam eps 1e-6 on both sides, as in
  tests/test_torch_train_step.py);
- `cli/train_sft.py` runs with `--device cpu` on a tiny jsonl dataset and
  writes its metrics and final checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.data.processor import MockTokenizer as JaxMockTokenizer
from spacer_tpu.data.processor import VLProcessor as JaxVLProcessor
from spacer_tpu.models.qwen25_vl import init_params, tiny_config
from spacer_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from spacer_tpu.train.sft_trainer import SFTConfig as JaxSFTConfig
from spacer_tpu.train.sft_trainer import SFTTrainer as JaxSFTTrainer
from spacer_tpu.train.sft_trainer import prepare_sft_example as jax_prepare
from spacer_tpu.train.step import make_sft_train_step as jax_make_sft_step
from spacer_tpu_torch.data import MockTokenizer, VLProcessor
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.train.optimizer import make_optimizer
from spacer_tpu_torch.train.sft_trainer import (
    SFTConfig,
    SFTTrainer,
    prepare_sft_example,
)
from spacer_tpu_torch.train.step import make_sft_train_step, param_leaves


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    import cv2

    vid = tmp_path_factory.mktemp("sft_video") / "clip.mp4"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (128, 96))
    base = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    for t in range(60):
        w.write(np.roll(base, 2 * t, axis=1))
    w.release()
    return str(vid)


def _rows(video):
    return [
        {"problem": "How many chairs are visible?", "problem_type": "numerical",
         "solution": "<think>two by the table</think><answer>3</answer>",
         "path": video, "data_type": "video"},
        {"problem": "Which is closer?", "problem_type": "multiple choice",
         "options": ["A. the chair", "B. the door"],
         "solution": "<think>hmm</think><answer>A</answer>",
         "path": video, "data_type": "video"},
    ]


def test_prepare_sft_example_equals_jax(video):
    for row in _rows(video):
        assert prepare_sft_example(row) == jax_prepare(row)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, video):
    cfg = tiny_config()
    jparams = init_params(jax.random.key(0), cfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    out = str(tmp_path_factory.mktemp("sft"))
    kw = dict(seq_bucket=128, output_dir=out, logp_chunk=8, remat=False)
    jt = JaxSFTTrainer(cfg, jparams, JaxVLProcessor(
        JaxMockTokenizer(vocab_size=cfg.text.vocab_size), cfg), _rows(video),
        JaxSFTConfig(**kw, attn_impl="xla"))
    tt = SFTTrainer(cfg, params_from_jax(np_params, cfg), VLProcessor(
        MockTokenizer(vocab_size=cfg.text.vocab_size), cfg), _rows(video),
        SFTConfig(**kw))
    return cfg, np_params, jt, tt


@pytest.mark.parametrize("rows", [[0], [1], [0, 1]])
def test_collate_equals_jax(setup, rows):
    _, _, jt, tt = setup
    jb, jgrid = jt.collate([jt.dataset[i] for i in rows])
    tb, grid = tt.collate([tt.dataset[i] for i in rows])
    assert grid == jgrid and grid is not None
    assert set(tb) == set(jb)
    for k in jb:
        if k == "pixel_values":
            # the two packages' bicubic resizes sum in other orders
            # (tests/test_torch_processor.py's tolerance)
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       atol=1e-4, rtol=0)
        else:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
    labels = tb["labels"].numpy()
    cfg = setup[0]
    for tok in (0, cfg.vision_start_token_id, cfg.vision_end_token_id,
                cfg.video_token_id):
        assert not (labels == tok).any()
    assert (labels != -100).sum() > 0


def test_two_sft_steps_match_jax(setup):
    cfg, np_params, jt, tt = setup
    jb, grid = jt.collate(jt.dataset)
    tb, _ = tt.collate(tt.dataset)
    # the same pixels on both sides, so the steps differ in arithmetic only
    tb["pixel_values"] = torch.from_numpy(np.asarray(jb["pixel_values"]))
    opt_kw = dict(learning_rate=1e-3, total_steps=10, eps=1e-6,
                  max_grad_norm=0.5)
    jtx = jax_make_optimizer(**opt_kw)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jtx.init(jparams)
    jstep = jax_make_sft_step(cfg, jtx, remat=True, attn_impl="xla",
                              logp_chunk=8)
    tx = make_optimizer(**opt_kw)
    params = params_from_jax(np_params, cfg)
    leaves = param_leaves(params)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    step = make_sft_train_step(cfg, tx, remat=True, logp_chunk=8)
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    for _ in range(2):
        with jax.default_matmul_precision("highest"):
            jparams, jstate, jm = jstep(jparams, jstate, jbatch, grid_thw=grid)
        params, state, m = step(params, state, tb, grid_thw=grid)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        assert int(m["n_tokens"]) == int(jm["n_tokens"])
    jl = [t.numpy() for _, t in param_leaves(
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg))]
    for (name, t), b in zip(param_leaves(params), jl):
        np.testing.assert_allclose(t.detach().numpy(), b, atol=5e-6,
                                   err_msg=name)


def test_train_sft_cli(tmp_path, video):
    data = tmp_path / "sft.jsonl"
    with open(data, "w") as f:
        for i, row in enumerate(_rows(video)):
            f.write(json.dumps(dict(row, problem_id=i)) + "\n")
    from spacer_tpu_torch.cli.train_sft import main

    out = tmp_path / "sft_out"
    main(["--dataset_name", str(data), "--random_init", "true",
          "--dtype", "float32", "--output_dir", str(out), "--max_steps", "2",
          "--seq_bucket", "128", "--remat", "dots_narrow", "--logp_chunk",
          "8", "--moment_dtype", "int8", "--device", "cpu"])
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(recs) == 2
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in recs)
    assert os.path.exists(out / "final" / "params.pt")
    assert os.path.exists(out / "final" / "opt_state.pt")
