"""Publishing from spacer_tpu_torch (counterpart of tests/test_publish.py):
`save_pretrained` writes an HF layout (model.safetensors, config.json with
use_cache and the params' torch_dtype, the processor files of a source
checkpoint and never its weights) that `load_params_from_hf` reads back
bitwise, in float32 and bfloat16, and that spacer_tpu's loader reads too;
`push_to_hub` goes through an injected API object or a stub
`huggingface_hub` module (no network), and refuses without a repo id;
`SGRLVRTrainer.save_pretrained` exports the trained params and publishes
through the stub, and refuses push_to_hub without hub_model_id before
writing anything."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
from spacer_tpu_torch.models.qwen25_vl.loading import load_params_from_hf
from spacer_tpu_torch.train.publish import push_to_hub, save_pretrained
from spacer_tpu_torch.train.step import param_leaves


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_pretrained_layout_and_roundtrip(tmp_path, dtype):
    cfg = tiny_config()
    params = init_params(cfg, seed=0, dtype=dtype)
    src = tmp_path / "src"
    src.mkdir()
    (src / "tokenizer_config.json").write_text('{"pad_token": "<pad>"}')
    (src / "preprocessor_config.json").write_text('{"patch_size": 14}')
    (src / "model-00001.safetensors").write_text("not copied")
    out = save_pretrained(str(tmp_path / "out"), params, cfg,
                          processor_dir=str(src))
    names = set(os.listdir(out))
    assert {"model.safetensors", "config.json", "tokenizer_config.json",
            "preprocessor_config.json"} <= names
    assert "model-00001.safetensors" not in names
    hf_cfg = json.loads((tmp_path / "out" / "config.json").read_text())
    assert hf_cfg["use_cache"] is True
    assert hf_cfg["torch_dtype"] == str(dtype).removeprefix("torch.")
    assert hf_cfg["num_hidden_layers"] == cfg.text.num_layers
    back, cfg2 = load_params_from_hf(out, dtype=dtype, device="cpu")
    assert cfg2.text == cfg.text and cfg2.vision == cfg.vision
    got = dict(param_leaves(back))
    assert set(got) == {n for n, _ in param_leaves(params)}
    for n, a in param_leaves(params):
        assert a.dtype == got[n].dtype and torch.equal(a, got[n]), n


def test_save_pretrained_loads_into_jax(tmp_path):
    import jax

    from spacer_tpu.models.qwen25_vl.loading import load_params_from_hf as jl
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax

    cfg = tiny_config()
    params = init_params(cfg, seed=1)
    out = save_pretrained(str(tmp_path / "out"), params, cfg)
    import jax.numpy as jnp

    jparams, _ = jl(out, dtype=jnp.float32)
    got = dict(param_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)))
    for n, a in param_leaves(params):
        assert torch.equal(a, got[n]), n


class _StubApi:
    def __init__(self, token=None):
        self.calls = [("init", token)]
        _StubApi.last = self

    def create_repo(self, repo_id, private=True, exist_ok=True):
        self.calls.append(("create_repo", repo_id, private))

    def upload_folder(self, repo_id, folder_path):
        self.calls.append(("upload_folder", repo_id, folder_path))


def test_push_to_hub_call_path(tmp_path, monkeypatch):
    api = _StubApi()
    assert push_to_hub("org/spacer", str(tmp_path), api=api) == "org/spacer"
    assert api.calls[1:] == [("create_repo", "org/spacer", True),
                             ("upload_folder", "org/spacer", str(tmp_path))]
    # the default resolves huggingface_hub at call time
    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=_StubApi))
    push_to_hub("org/other", str(tmp_path), token="t", private=False)
    assert _StubApi.last.calls == [("init", "t"),
                                   ("create_repo", "org/other", False),
                                   ("upload_folder", "org/other", str(tmp_path))]
    with pytest.raises(ValueError, match="repo id"):
        push_to_hub("", str(tmp_path), api=api)


def test_push_to_hub_without_the_package_says_what_to_do(tmp_path,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        push_to_hub("org/x", str(tmp_path))


def test_trainer_save_pretrained(tmp_path, monkeypatch):
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    cfg = tiny_config()
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)

    def trainer(**kw):
        return SGRLVRTrainer(
            cfg, init_params(cfg, seed=0), proc, [], [],
            SGRLVRConfig(decode_quant=None, output_dir=str(tmp_path / "o"),
                         **kw))

    out = trainer().save_pretrained()
    assert out == str(tmp_path / "o" / "final")
    back, _ = load_params_from_hf(out, dtype=torch.float32, device="cpu")
    assert torch.equal(back["model"]["norm"]["scale"],
                       init_params(cfg, seed=0)["model"]["norm"]["scale"])
    with pytest.raises(ValueError, match="hub_model_id"):
        trainer(push_to_hub=True).save_pretrained(str(tmp_path / "never"))
    assert not os.path.exists(tmp_path / "never")
    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=_StubApi))
    out = trainer(push_to_hub=True, hub_model_id="org/spacer").save_pretrained(
        str(tmp_path / "pub"))
    assert _StubApi.last.calls[-1] == ("upload_folder", "org/spacer", out)
