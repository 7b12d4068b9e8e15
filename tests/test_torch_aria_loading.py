"""Aria checkpoints across the two packages, at tiny_aria_config: the port's
export read by spacer_tpu's load_params_from_hf, spacer_tpu's export read
by the port's, both bitwise (float32, and bfloat16 through the port's own
round trip), a sharded round trip, and the port's save_pretrained for the
Aria family (config.json that AriaConfig.from_hf_config reads back, the
processor files beside it)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models import aria as jaria
from spacer_tpu.models.aria.loading import export_to_safetensors as jax_export
from spacer_tpu.models.aria.loading import load_params_from_hf as jax_load
from spacer_tpu_torch.models import aria
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.train.publish import save_pretrained
from spacer_tpu_torch.train.step import param_leaves


def _leaves_equal(a, b):
    la, lb = dict(param_leaves(a)), dict(param_leaves(b))
    assert set(la) == set(lb)
    for name, t in la.items():
        assert t.dtype == lb[name].dtype, name
        assert torch.equal(t, lb[name]), name


def test_port_export_loads_in_jax_bitwise(tmp_path):
    cfg = aria.tiny_aria_config()
    params = aria.init_params(cfg, seed=1)
    out = aria.export_to_safetensors(params, cfg, str(tmp_path / "ckpt"))
    jparams, jcfg = jax_load(out, dtype=jnp.float32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    back = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    _leaves_equal(back, params)


def test_jax_export_loads_in_port_bitwise(tmp_path):
    cfg = aria.tiny_aria_config()
    jparams = jaria.init_params(jax.random.key(2), cfg, jnp.float32)
    os.makedirs(tmp_path / "ckpt")
    jax_export(jparams, cfg, str(tmp_path / "ckpt" / "model.safetensors"))
    with open(tmp_path / "ckpt" / "config.json", "w") as f:
        json.dump(aria.config_to_hf_dict(cfg, "float32"), f)
    got, got_cfg = aria.load_params_from_hf(str(tmp_path / "ckpt"),
                                            dtype=torch.float32, device="cpu")
    assert got_cfg.text == cfg.text and got_cfg.vision == cfg.vision
    assert got_cfg.patch_to_query == cfg.patch_to_query
    _leaves_equal(got, params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_round_trip_sharded(tmp_path, dtype):
    cfg = aria.tiny_aria_config()
    params = aria.init_params(cfg, seed=3, dtype=dtype)
    out = aria.export_to_safetensors(params, cfg, str(tmp_path / "ckpt"),
                                     max_shard_bytes=200_000)
    assert len([f for f in os.listdir(out)
                if f.endswith(".safetensors")]) > 1
    back, _ = aria.load_params_from_hf(out, dtype=dtype, device="cpu")
    _leaves_equal(back, params)


def test_save_pretrained_aria(tmp_path):
    cfg = aria.tiny_aria_config()
    params = aria.init_params(cfg, seed=4, dtype=torch.bfloat16)
    src = tmp_path / "src"
    src.mkdir()
    (src / "tokenizer_config.json").write_text("{}")
    out = save_pretrained(str(tmp_path / "out"), params, cfg,
                          processor_dir=str(src))
    assert {"model.safetensors", "config.json", "tokenizer_config.json"} <= set(
        os.listdir(out))
    hf_cfg = json.loads((tmp_path / "out" / "config.json").read_text())
    assert hf_cfg["model_type"] == "aria" and hf_cfg["use_cache"] is True
    assert hf_cfg["torch_dtype"] == "bfloat16"
    back, cfg2 = aria.load_params_from_hf(out, dtype=torch.bfloat16,
                                          device="cpu")
    assert cfg2.text == cfg.text and cfg2.vision == cfg.vision
    _leaves_equal(back, params)
