"""HF checkpoint loading in spacer_tpu_torch against spacer_tpu and the
`safetensors` package, at tiny size on the CPU.

Every comparison of weights is bitwise (torch.equal / assert_array_equal):
loading moves and transposes bytes, it computes nothing.  Greedy tokens
through a loaded checkpoint must be identical to the JAX package's on the
same checkpoint (both f32; they differ in summation order only, far below
the logit gaps of a random tiny model's argmax).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl import get_rope_index
from spacer_tpu.models.qwen25_vl.loading import (
    export_to_safetensors as jax_export,
    load_params_from_hf as jax_load,
)
from spacer_tpu.sampler import Sampler as JaxSampler
from spacer_tpu_torch.models.qwen25_vl import (
    QWEN25_VL_7B,
    export_to_safetensors,
    init_params,
    load_params_from_hf,
    params_from_jax,
    tiny_config,
)
from spacer_tpu_torch.models.qwen25_vl import safetensors_io as st
from spacer_tpu_torch.models.qwen25_vl.loading import config_to_hf_dict
from spacer_tpu_torch.sampler import Sampler

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def _assert_params_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def _jax_params(dtype, seed=0, cfg=None):
    cfg = cfg or tiny_config()
    return jax_init_params(jax.random.key(seed), cfg, JAX_DTYPES[dtype]), cfg


def _write_config(d, cfg, dtype="float32"):
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config_to_hf_dict(cfg, dtype), f)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "i8"])
def test_safetensors_io_matches_the_package_both_ways(tmp_path, dtype):
    """Port writer -> package reader and package writer -> port reader, each
    bitwise, for tensors of several shapes (one empty)."""
    from safetensors import safe_open
    from safetensors.torch import save_file as pkg_save

    g = torch.Generator().manual_seed(0)
    shapes = {"a": (3, 5), "b.weight": (7,), "c": (2, 3, 4), "empty": (0, 4)}
    tensors = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=g) * 50
        tensors[name] = x.to(dtype)
    ours = str(tmp_path / "ours.safetensors")
    st.save_file([st.TensorSpec(k, v.dtype, tuple(v.shape), lambda v=v: v)
                  for k, v in tensors.items()], ours, {"format": "pt"})
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert set(f.keys()) == set(tensors)
        for k, v in tensors.items():
            assert torch.equal(f.get_tensor(k), v), k
    theirs = str(tmp_path / "theirs.safetensors")
    pkg_save(tensors, theirs, metadata={"format": "pt"})
    sf = st.SafetensorsFile(theirs)
    assert sf.metadata == {"format": "pt"} and set(sf.keys()) == set(tensors)
    for k, v in tensors.items():
        got = sf.get_tensor(k)
        assert got.dtype == dtype and torch.equal(got, v), k
        sf.release(k)
        assert torch.equal(sf.get_tensor(k), v), k   # pages fault back in
    sf.close()


def test_safetensors_reader_rejects_a_bad_header(tmp_path):
    path = tmp_path / "bad.safetensors"
    header = json.dumps({"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 8]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="offsets"):
        st.SafetensorsFile(str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_export_loads_into_the_port_bitwise(tmp_path, dtype):
    """spacer_tpu's export_to_safetensors -> the port's load_params_from_hf
    equals params_from_jax of the same tree, and config.json round-trips
    the geometry."""
    params, cfg = _jax_params(dtype)
    jax_export(params, cfg, str(tmp_path / "model.safetensors"))
    _write_config(tmp_path, cfg, dtype)
    loaded, lcfg = load_params_from_hf(str(tmp_path), dtype=TORCH_DTYPES[dtype],
                                       device="cpu")
    assert lcfg.text == cfg.text and lcfg.vision == cfg.vision
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           dtype=TORCH_DTYPES[dtype])
    _assert_params_equal(loaded, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_export_loads_into_jax_bitwise(tmp_path, dtype):
    """The port's export_to_safetensors (a checkpoint directory, sharded) ->
    spacer_tpu's load_params_from_hf equals the JAX tree it came from."""
    params, cfg = _jax_params(dtype, seed=1)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              dtype=TORCH_DTYPES[dtype])
    export_to_safetensors(tparams, cfg, str(tmp_path), max_shard_bytes=40_000)
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".safetensors")]) >= 2
    loaded, _ = jax_load(str(tmp_path), dtype=JAX_DTYPES[dtype])
    flat, want = (jax.tree_util.tree_leaves_with_path(t)
                  for t in (loaded, params))
    for (pa, a), (pb, b) in zip(flat, want):
        assert str(pa) == str(pb)
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, pa
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=str(pa))


def _roundtrip(tmp_path, cfg, **kw):
    params = init_params(cfg, seed=3, dtype=torch.bfloat16)
    export_to_safetensors(params, cfg, str(tmp_path), **kw)
    loaded, lcfg = load_params_from_hf(str(tmp_path), device="cpu")
    return params, loaded, lcfg


@pytest.mark.parametrize("layout", ["single", "sharded", "tied"])
def test_checkpoint_layouts_load_the_same_params(tmp_path, layout):
    """One file, HF's index with shards, and tied embeddings (no lm_head
    tensor) each load back bitwise; a loaded param owns its memory."""
    cfg = tiny_config()
    kw = {}
    if layout == "sharded":
        kw = {"max_shard_bytes": 60_000}
    if layout == "tied":
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, tie_word_embeddings=True))
    params, loaded, lcfg = _roundtrip(tmp_path, cfg, **kw)
    _assert_params_equal(loaded, params)
    assert lcfg.text.tie_word_embeddings == (layout == "tied")
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["torch_dtype"] == "bfloat16"
    if layout == "sharded":
        with open(tmp_path / st.INDEX_FILE) as f:
            index = json.load(f)
        files = set(index["weight_map"].values())
        assert len(files) >= 2 and files <= set(os.listdir(tmp_path))
        assert index["metadata"]["total_size"] == sum(
            t.numel() * t.element_size() for _, t in _leaves(params))
    if layout == "tied":
        assert "lm_head" not in loaded["model"]
    loaded["model"]["norm"]["scale"].add_(1)    # writable, not the map


def test_new_hf_prefixes_load_the_same_params(tmp_path):
    """Newer transformers name the LM `model.language_model.*` and the ViT
    `model.visual.*`; both load as the legacy names do."""
    cfg = tiny_config()
    params = init_params(cfg, seed=4, dtype=torch.float32)
    export_to_safetensors(params, cfg, str(tmp_path / "old"))
    old = st.SafetensorsFile(str(tmp_path / "old" / "model.safetensors"))

    def renamed(k):
        if k.startswith("model."):
            return "model.language_model." + k[len("model."):]
        if k.startswith("visual."):
            return "model." + k
        return k

    specs = [st.TensorSpec(renamed(k), t.dtype, tuple(t.shape),
                           lambda k=k: old.get_tensor(k))
             for k, t in ((k, old.get_tensor(k)) for k in old.keys())]
    os.makedirs(tmp_path / "new")
    st.save_file(specs, str(tmp_path / "new" / "model.safetensors"))
    _write_config(tmp_path / "new", cfg)
    loaded, _ = load_params_from_hf(str(tmp_path / "new"),
                                    dtype=torch.float32, device="cpu")
    _assert_params_equal(loaded, params)


def test_qwen2_vl_checkpoint_is_refused(tmp_path):
    cfg = tiny_config(arch="qwen2")
    with pytest.raises(NotImplementedError, match="Qwen2-VL"):
        load_params_from_hf(str(tmp_path), cfg=cfg, device="cpu")


def _hf_name_shapes(tcfg, vcfg):
    """Every tensor of an HF Qwen2.5-VL checkpoint: name -> (out, in) shape."""
    D, I, V = tcfg.hidden_size, tcfg.intermediate_size, tcfg.vocab_size
    q, kv = tcfg.num_heads * tcfg.head_dim, tcfg.num_kv_heads * tcfg.head_dim
    names = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,),
             "lm_head.weight": (V, D)}
    for i in range(tcfg.num_layers):
        p = f"model.layers.{i}."
        names.update({
            p + "input_layernorm.weight": (D,),
            p + "post_attention_layernorm.weight": (D,),
            p + "self_attn.q_proj.weight": (q, D), p + "self_attn.q_proj.bias": (q,),
            p + "self_attn.k_proj.weight": (kv, D), p + "self_attn.k_proj.bias": (kv,),
            p + "self_attn.v_proj.weight": (kv, D), p + "self_attn.v_proj.bias": (kv,),
            p + "self_attn.o_proj.weight": (D, q),
            p + "mlp.gate_proj.weight": (I, D), p + "mlp.up_proj.weight": (I, D),
            p + "mlp.down_proj.weight": (D, I)})
    VD, VI = vcfg.hidden_size, vcfg.intermediate_size
    merged = VD * vcfg.spatial_merge_unit
    names.update({
        "visual.patch_embed.proj.weight": (VD, 3, vcfg.temporal_patch_size,
                                           vcfg.patch_size, vcfg.patch_size),
        "visual.merger.ln_q.weight": (VD,),
        "visual.merger.mlp.0.weight": (merged, merged),
        "visual.merger.mlp.0.bias": (merged,),
        "visual.merger.mlp.2.weight": (vcfg.out_hidden_size, merged),
        "visual.merger.mlp.2.bias": (vcfg.out_hidden_size,)})
    for i in range(vcfg.depth):
        p = f"visual.blocks.{i}."
        names.update({
            p + "norm1.weight": (VD,), p + "norm2.weight": (VD,),
            p + "attn.qkv.weight": (3 * VD, VD), p + "attn.qkv.bias": (3 * VD,),
            p + "attn.proj.weight": (VD, VD), p + "attn.proj.bias": (VD,),
            p + "mlp.gate_proj.weight": (VI, VD), p + "mlp.gate_proj.bias": (VI,),
            p + "mlp.up_proj.weight": (VI, VD), p + "mlp.up_proj.bias": (VI,),
            p + "mlp.down_proj.weight": (VD, VI), p + "mlp.down_proj.bias": (VD,)})
    return names


def test_streaming_load_7b_geometry(tmp_path):
    """Qwen2.5-VL-7B widths with 2 LM layers, 2 ViT blocks and the vocab cut
    to 8192 (the full-vocab pair is ~2 GB of I/O), written as 3 shards by
    streaming producers (zeros and a bf16 marker at flat[0]): every tensor
    lands transposed in its slot and the load covers every checkpoint
    tensor."""
    t7, v7 = QWEN25_VL_7B.text, QWEN25_VL_7B.vision
    cfg = dataclasses.replace(
        QWEN25_VL_7B,
        text=dataclasses.replace(t7, num_layers=2, vocab_size=8192),
        vision=dataclasses.replace(v7, depth=2, fullatt_block_indexes=(1,)))
    shapes = _hf_name_shapes(cfg.text, cfg.vision)
    marker = {k: float(j % 250 + 1) for j, k in enumerate(sorted(shapes))}

    def produce(k):
        x = torch.zeros(shapes[k], dtype=torch.bfloat16)
        x.view(-1)[0] = marker[k]
        return x

    specs = [st.TensorSpec(k, torch.bfloat16, shapes[k],
                           lambda k=k: produce(k)) for k in sorted(shapes)]
    total = sum(st.nbytes(s) for s in specs)
    assert len(st.save_sharded(specs, str(tmp_path), total // 3 + 1)) >= 3
    _write_config(tmp_path, cfg, "bfloat16")
    params, _ = load_params_from_hf(str(tmp_path), device="cpu")
    layers = params["model"]["layers"]
    for i in range(2):
        q = layers[i]["self_attn"]["q_proj"]["kernel"]
        assert q.shape == (t7.hidden_size, t7.num_heads * t7.head_dim)
        assert float(q[0, 0]) == marker[f"model.layers.{i}.self_attn.q_proj.weight"]
    lm = params["model"]["lm_head"]["kernel"]
    assert lm.shape == (t7.hidden_size, 8192)
    assert float(lm[0, 0]) == marker["lm_head.weight"]
    vq = params["visual"]["blocks"][1]["attn"]["qkv"]["kernel"]
    assert vq.shape == (v7.hidden_size, 3 * v7.hidden_size)
    assert float(vq[0, 0]) == marker["visual.blocks.1.attn.qkv.weight"]
    pe = params["visual"]["patch_embed"]["proj"]["kernel"]
    assert pe.shape == (v7.patch_dim, v7.hidden_size)
    assert float(pe[0, 0]) == marker["visual.patch_embed.proj.weight"]
    n_params = sum(x.numel() for _, x in _leaves(params))
    assert n_params == sum(int(np.prod(s)) for s in shapes.values())


def test_greedy_tokens_of_a_loaded_checkpoint_match_jax(tmp_path):
    """One tiny f32 checkpoint (the port's export), loaded by each package
    and decoded greedily from a video and a text prompt: identical tokens."""
    cfg = tiny_config()
    export_to_safetensors(init_params(cfg, seed=5), cfg, str(tmp_path))
    jparams, _ = jax_load(str(tmp_path), dtype=jnp.float32)
    tparams, _ = load_params_from_hf(str(tmp_path), dtype=torch.float32,
                                     device="cpu")
    grid = ((2, 8, 8),)
    video = ([10, 11, cfg.vision_start_token_id]
             + [cfg.video_token_id] * (2 * 8 * 8 // 4)
             + [cfg.vision_end_token_id, 20, 21])
    text = [30 + i for i in range(12)]
    L = len(video)
    ids = np.array([video, [cfg.pad_token_id] * (L - len(text)) + text])
    mask = np.array([[1] * L, [0] * (L - len(text)) + [1] * len(text)])
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=np.array(grid),
                                 attention_mask=mask)
    px = np.random.default_rng(0).normal(
        size=(2 * 8 * 8, cfg.vision.patch_dim)).astype(np.float32)
    kw = dict(position_ids=pos, deltas=deltas, pixel_values=px, grid_thw=grid,
              num_generations=1, max_new_tokens=10, temperature=0.0,
              top_p=1.0, seed=0)
    ref = JaxSampler(cfg, length_bucket=64, decode_impl="flash_ref").generate(
        ids, mask, jparams, **kw)
    out = Sampler(cfg, length_bucket=64).generate(ids, mask, tparams, **kw)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths, np.asarray(ref.lengths))


def test_tokenizer_without_transformers_raises_clearly(tmp_path, monkeypatch):
    """A checkpoint path loads its weights with no transformers package; the
    tokenizer is the one part that needs it, and says so."""
    from spacer_tpu_torch.cli.common import ModelArgs, load_model_and_processor

    cfg = tiny_config()
    export_to_safetensors(init_params(cfg), cfg, str(tmp_path))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        load_model_and_processor(ModelArgs(model_name_or_path=str(tmp_path),
                                           device="cpu"))
