"""The serving slice as a whole: spacer_tpu_torch's QwenEngine.generate_many
(processor -> ViT -> prefill -> clock-ring decode -> greedy sampling)
against spacer_tpu's on the same converted weights, and the serve CLI.

Greedy decoding in float32 must give IDENTICAL token ids: both packages run
the same math, and a masking or ring-index bug shows as a different token.
The quantized batchers (decode_quant "int8_kv" / "int4_kv") are held against
the JAX batcher's head-major path (decode_impl="flash_ref") the same way.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.data.processor import MockTokenizer as JaxTokenizer
from spacer_tpu.data.processor import VLProcessor as JaxProcessor
from spacer_tpu.evalharness.engine import QwenEngine as JaxEngine
from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.models.registry import encode_request as jax_encode_request
from spacer_tpu.sampler.sampler import filtered_logits as jax_filtered_logits
from spacer_tpu.serving import ContinuousBatcher as JaxBatcher
from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
from spacer_tpu_torch.evalharness.engine import QwenEngine
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.sampler.sampler import filtered_logits
from spacer_tpu_torch.serving import ContinuousBatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _messages():
    from PIL import Image

    rng = np.random.default_rng(0)

    def frames(n, size):
        return [Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8))
                for _ in range(n)]

    def user(*content):
        return [{"role": "user", "content": list(content)}]

    return [
        user({"type": "video", "video": frames(4, 112)},
             {"type": "text", "text": "what is on the table"}),
        user({"type": "text", "text": "count the chairs in the room please"}),
        user({"type": "video", "video": frames(2, 56)},
             {"type": "text", "text": "and here"}),
        user({"type": "text", "text": "x y z"}),
    ]


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(0), cfg, jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    jproc = JaxProcessor(JaxTokenizer(cfg.text.vocab_size), cfg)
    proc = VLProcessor(MockTokenizer(cfg.text.vocab_size), cfg)
    return cfg, params, tparams, jproc, proc


def test_generate_many_greedy_token_ids_match_jax(engines):
    cfg, params, tparams, jproc, proc = engines
    kw = dict(max_new_tokens=10, temperature=0.0, slots=2, chunk_steps=3)
    jtexts = JaxEngine(cfg, params, jproc, length_bucket=64).generate_many(
        copy.deepcopy(_messages()), **kw)
    engine = QwenEngine(cfg, tparams, proc, length_bucket=64)
    texts = engine.generate_many(copy.deepcopy(_messages()), **kw)
    assert texts == jtexts

    # the same requests at the batcher level: identical token ids, with
    # 4 requests through 2 slots (refill) in one prompt bucket
    jreqs = [jax_encode_request(jproc, cfg, m)
             for m in copy.deepcopy(_messages())]
    reqs = [engine.encode_request(m) for m in copy.deepcopy(_messages())]
    Pmax = max(r["input_ids"].shape[1] for r in reqs)
    common = dict(slots=2, prompt_len=Pmax, max_new_tokens=12, temperature=0.0,
                  chunk_steps=4, eos_token_id=proc.eos_token_id,
                  pad_token_id=proc.pad_token_id)
    jouts = JaxBatcher(cfg, params, dtype=jnp.float32, **common).run(jreqs)
    outs = ContinuousBatcher(cfg, tparams, **common).run(reqs)
    for o, jo in zip(outs, jouts):
        assert o.length == jo.length
        np.testing.assert_array_equal(o.sequences[:o.length],
                                      np.asarray(jo.sequences)[:jo.length])


@pytest.mark.parametrize("quant", ["int8_kv", "int4_kv"])
def test_quantized_batcher_greedy_token_ids_match_jax(engines, quant):
    """4 requests through 2 slots (refill), int8 caches, int8 / int4
    weights: identical token ids to the JAX batcher."""
    cfg, params, tparams, jproc, proc = engines
    engine = QwenEngine(cfg, tparams, proc, length_bucket=64)
    jreqs = [jax_encode_request(jproc, cfg, m)
             for m in copy.deepcopy(_messages())]
    reqs = [engine.encode_request(m) for m in copy.deepcopy(_messages())]
    Pmax = max(r["input_ids"].shape[1] for r in reqs)
    common = dict(slots=2, prompt_len=Pmax, max_new_tokens=12, temperature=0.0,
                  chunk_steps=4, eos_token_id=proc.eos_token_id,
                  pad_token_id=proc.pad_token_id, decode_quant=quant)
    jouts = JaxBatcher(cfg, params, dtype=jnp.float32, decode_impl="flash_ref",
                       **common).run(jreqs)
    batcher = ContinuousBatcher(cfg, tparams, **common)
    assert batcher.caches[0][0].dtype == torch.int8
    assert ("kernel_q4" in batcher.decode_model["lm_head"]) == (quant == "int4_kv")
    outs = batcher.run(reqs)
    for o, jo in zip(outs, jouts):
        assert o.length == jo.length
        np.testing.assert_array_equal(o.sequences[:o.length],
                                      np.asarray(jo.sequences)[:jo.length])
    with pytest.raises(ValueError, match="decode_quant"):
        ContinuousBatcher(cfg, tparams, **dict(common, decode_quant="int2"))


def test_filtered_logits_match_jax_top_p():
    logits = np.random.default_rng(1).normal(size=(4, 512)).astype(np.float32) * 3
    ref = np.asarray(jax_filtered_logits(jnp.asarray(logits), 0.7, 0.9))
    out = filtered_logits(torch.from_numpy(logits), 0.7, 0.9).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    kept = ~np.isinf(ref)
    assert 0 < kept.sum() < kept.size
    np.testing.assert_allclose(out[kept], ref[kept], rtol=1e-6)


def _serve_cli(tmp_path, *extra, env_extra=None):
    inp, outp = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    rows = [{"prompt": "what is this"}, {"prompt": "and that one"},
            {"messages": [{"role": "user", "content": "hi"}]}]
    inp.write_text("".join(json.dumps(r) + "\n" for r in rows))
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    res = subprocess.run(
        [sys.executable, "-m", "spacer_tpu_torch.cli.serve",
         "--random_init", "true", "--dtype", "float32",
         "--input_file", str(inp), "--output_file", str(outp),
         "--max_new_tokens", "4", "--slots", "2", *extra],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    return rows, outp, res


def test_serve_cli_int4_kv_writes_completions(tmp_path):
    rows, outp, res = _serve_cli(tmp_path, "--device", "cpu",
                                 "--decode_quant", "int4_kv")
    assert res.returncode == 0, res.stderr
    out = [json.loads(line) for line in outp.read_text().splitlines()]
    assert len(out) == len(rows)
    assert all(isinstance(o["completion"], str) for o in out)


def test_serve_cli_without_cuda_refuses_the_cpu(tmp_path):
    """No --device: the card, and on a host without CUDA an error, never a
    silent CPU run."""
    rows, outp, res = _serve_cli(tmp_path,
                                 env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "--device cpu" in res.stderr
    assert not outp.exists()


def test_serve_cli_writes_one_completion_per_row(tmp_path):
    rows, outp, res = _serve_cli(tmp_path, "--device", "cpu")
    assert res.returncode == 0, res.stderr
    out = [json.loads(line) for line in outp.read_text().splitlines()]
    assert len(out) == len(rows)
    assert all(isinstance(o["completion"], str) for o in out)
    assert [o.get("prompt") for o in out] == [r.get("prompt") for r in rows]
