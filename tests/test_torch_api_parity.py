"""The port's public API against the JAX package's, by source alone.

Both trees are parsed with `ast`; neither package is imported.  For every
module of spacer_tpu/ the port has a module at the same path under
spacer_tpu_torch/, and in it:

- every public top-level function and class of the JAX module, under the
  same name;
- every keyword of such a function, which the port's counterpart accepts
  (a `**kwargs` accepts all);
- for a public class, every keyword of its constructor (a dataclass's
  fields, else `__init__`'s), every public method, and every keyword of
  each such method.

Anything else stands in EXCEPTIONS with its reason (ROADMAP's "Not to
port" list).  An exception is stale, and fails the test, once the port
has the name or keyword it excuses, or the JAX package no longer has it.

Keys: "path::name" (a function or class), "path::name(kw)" (a keyword of
a function or constructor), "path::Class.method" and
"path::Class.method(kw)".
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "spacer_tpu"
PORT_PKG = ROOT / "spacer_tpu_torch"

_GATE = ("a Mosaic tile-legality gate; each Hopper kernel checks its own "
         "shapes (_check) and raises")
_INTERPRET = ("Pallas interpret mode; on the port a CPU tensor takes the "
              "plain version and utils.debugging.interpret_kernels routes "
              "CUDA calls to it")
_KEY = ("a jax.random key; the port draws from a torch.Generator seeded by "
        "`seed`")
_HEAD_MAJOR = ("the XLA / Pallas choice of the TPU decode; the port has one "
               "head-major path, K2 / K5 on the card, the plain version on "
               "the CPU")
_DECODE_IMPL = ("decode_impl is not ported: the port has one decode path "
                "per device")
_ATTN_IMPL = ("the attn_impl strings 'xla' / 'pallas' are not ported: the "
              "device picks the path")

EXCEPTIONS = {
    # the Mosaic gates
    "ops/flash_decode.py::flash_decode_supported": _GATE,
    "ops/int4_matmul.py::int4_kernel_legal": _GATE,
    "ops/vit_window_attention.py::window_kernel_plan": _GATE,
    "ops/vit_window_attention.py::chunk_kernel_supported": _GATE,
    # TPU-only keywords
    "ops/flash_attention.py::flash_attention(block_q)":
        "a Pallas block size; K1's tiles are fixed by its wgmma design",
    "ops/flash_attention.py::flash_attention(block_k)":
        "a Pallas block size; K1's tiles are fixed by its wgmma design",
    "ops/flash_attention.py::flash_attention(interpret)": _INTERPRET,
    "ops/flash_decode.py::flash_decode_attention(interpret)": _INTERPRET,
    "ops/flash_decode.py::flash_ragged_decode_attention(interpret)":
        _INTERPRET,
    "ops/int4_matmul.py::int4_matmul(interpret)": _INTERPRET,
    "ops/vit_window_attention.py::window_attention_hsd(interpret)":
        _INTERPRET,
    "ops/vit_window_attention.py::chunk_attention_hsd(interpret)":
        _INTERPRET,
    "ops/vit_window_attention.py::window_attention(interpret)": _INTERPRET,
    "ops/vit_window_attention.py::make_window_attention(interpret)":
        _INTERPRET,
    "ops/ring_attention.py::ring_attention(axis_name)":
        "a shard_map axis name; the port's per-rank body takes the axis's "
        "process group (`group`)",
    "ops/ring_attention.py::make_ring_attention(axis_name)":
        "renamed `axis` (the mesh axis, as the ring attn_impl tuple names "
        "it)",
    "nn/core.py::dense(precision)":
        "an XLA matmul precision; the port's products are torch's, TF32 "
        "off",
    "parallel/mesh.py::create_mesh(devices)":
        "a JAX device list; a port rank's device is its process's",
    "parallel/multihost.py::place_global_batch(donate_unused)":
        "XLA buffer donation; torch frees tensors by reference",
    "train/step.py::make_grpo_train_step(prompt_len)":
        "jit's static prompt bucket; the port reads the prompt length off "
        "the batch",
    "models/qwen25_vl/language.py::lm_decode_step_split(head_major)":
        _HEAD_MAJOR,
    "models/qwen25_vl/language.py::lm_decode_step_split(use_kernel)":
        _HEAD_MAJOR,
    "models/qwen25_vl/language.py::lm_decode_step_split(prefix_mask)":
        "the head-major step takes the prefix mask as its additive f32 "
        "`bias_p`, built once per rollout (JAX's head-major branch builds "
        "the same)",
    "models/qwen25_vl/language.py::lm_decode_step_split(tail_mask)":
        "JAX's head-major branch ignores it for the live length `tail_len`, "
        "which the port takes alone",
    "serving/ragged.py::ragged_decode_step(head_major)": _HEAD_MAJOR,
    "serving/ragged.py::ragged_decode_step(use_kernel)": _HEAD_MAJOR,
    "evalharness/engine.py::QwenEngine.generate_many(prompt_bucket)":
        "a fixed TPU program bucket; the port buckets by length alone",
    # JAX's random keys
    "ops/moe.py::init_moe_params(key)": _KEY,
    "nn/core.py::dense_init(key)": _KEY,
    "nn/core.py::embed_init(key)": _KEY,
    "train/lora.py::init_lora_params(key)": _KEY,
    "models/aria/language.py::init_lm_params(key)": _KEY,
    "models/aria/model.py::init_params(key)": _KEY,
    "models/aria/vision.py::init_vit_params(key)": _KEY,
    "models/aria/vision.py::init_projector_params(key)": _KEY,
    "models/qwen25_vl/language.py::init_lm_params(key)": _KEY,
    "models/qwen25_vl/model.py::init_params(key)": _KEY,
    "models/qwen25_vl/vision.py::init_vit_params(key)": _KEY,
    "sampler/sampler.py::sample_logits(rng)":
        "a jax.random key; the port takes a torch.Generator (`generator`)",
    "sampler/speculating.py::spec_decode_loop(rng)":
        "a jax.random key; the port takes a torch.Generator (`generator`)",
    # the TPU lane layout, optax, XLA policies and jit wrappers
    "nn/rope.py::rotate_half_matrix":
        "a TPU lane-layout form of rotate_half (a matmul at head_dim 80); "
        "the port rotates by slicing",
    "train/optimizer.py::scale_by_adam_8bit":
        "an optax transform; its counterpart is AdamW(moment_dtype='int8')",
    "train/optimizer.py::ScaleByAdam8bitState":
        "an optax transform's state; AdamW holds its moments",
    "train/optimizer.py::scale_by_adam_f32":
        "an optax transform; its counterpart is AdamW(moment_dtype="
        "'float32')",
    "train/optimizer.py::ScaleByAdamF32State":
        "an optax transform's state; AdamW holds its moments",
    "train/step.py::optax_global_norm":
        "optax's global norm; its counterpart is train/optimizer.global_norm",
    "serving/speculative.py::spec_chunk_jit":
        "a jit wrapper of the speculative chunk; the port runs spec_chunk "
        "eagerly",
    "models/qwen25_vl/language.py::narrow_dots_policy":
        "a jax.checkpoint policy; the port's is _dots_policy, selected by "
        "check_remat's modes",
    # keywords the port renamed
    "models/qwen25_vl/loading.py::params_from_torch_state_dict(state_dict)":
        "renamed `state` (a mapping or the lazy CheckpointShards)",
    "models/aria/loading.py::params_from_torch_state_dict(state_dict)":
        "renamed `state` (a mapping or the lazy CheckpointShards)",
    "models/qwen25_vl/loading.py::export_to_safetensors(out_path)":
        "renamed `path_or_dir` (a file, or a directory of shards)",
    "models/aria/loading.py::export_to_safetensors(out_path)":
        "renamed `path_or_dir` (a file, or a directory of shards)",
    "parallel/multihost.py::fetch_to_host(arr)":
        "renamed `local`: this rank's rows, not a global array",
    "vision/process.py::patchify_frames(patch_size)":
        "fixed at Qwen's 14 (the module's PATCH_SIZE), as every caller "
        "passes it",
    "vision/process.py::patchify_frames(temporal_patch_size)":
        "fixed at Qwen's 2 (TEMPORAL_PATCH_SIZE)",
    "vision/process.py::patchify_frames(merge_size)":
        "fixed at Qwen's 2 (MERGE_SIZE)",
    "vision/process.py::preprocess_frames(patch_size)":
        "fixed at Qwen's 14 (PATCH_SIZE)",
    "vision/process.py::preprocess_frames(temporal_patch_size)":
        "fixed at Qwen's 2 (TEMPORAL_PATCH_SIZE)",
    "vision/process.py::preprocess_frames(merge_size)":
        "fixed at Qwen's 2 (MERGE_SIZE)",
    "sampler/speculating.py::spec_decode_loop(params)":
        "renamed `model`: the decode model (quantized, its layers inside)",
    "sampler/speculating.py::spec_decode_loop(layers)":
        "the layers travel inside `model` (the port's params hold a list)",
    "sampler/speculating.py::spec_decode_loop(prompt_mask)":
        "renamed `prefix_mask` (the prompt's mask is the prefix's)",
    # tracing the port replaced
    "utils/profiling.py::StepTimer":
        "wall-clock stage splits that no path of either package calls; the "
        "port times its stages with program spans (span, count, "
        "recording)",
    # constructor keywords of the TPU paths
    "evalharness/engine.py::QwenEngine(attn_impl)": _ATTN_IMPL,
    "evalharness/engine.py::QwenEngine(decode_impl)": _DECODE_IMPL,
    "sampler/sampler.py::Sampler(attn_impl)": _ATTN_IMPL,
    "sampler/sampler.py::Sampler(decode_impl)": _DECODE_IMPL,
    "serving/batcher.py::ContinuousBatcher(attn_impl)": _ATTN_IMPL,
    "serving/batcher.py::ContinuousBatcher(decode_impl)": _DECODE_IMPL,
    "serving/batcher.py::ContinuousBatcher(dtype)":
        "the caches take the params' dtype",
    "serving/server.py::OpenAIServer(decode_impl)": _DECODE_IMPL,
    "serving/server.py::OpenAIServer(dtype)":
        "the caches take the params' dtype",
    "cli/common.py::ModelArgs(decode_impl)": _DECODE_IMPL,
    "models/registry.py::ModelFamily(config_cls)":
        "family_for_config resolves a family by its config's class name",
}


def _is_dataclass(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if getattr(f, "id", getattr(f, "attr", None)) == "dataclass":
            return True
    return False


def _signature(fn) -> tuple:
    """(keyword names, takes **kwargs) of a function def."""
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs], bool(
        a.kwarg)


def _api(path: pathlib.Path) -> dict:
    """{name: ("function", (kws, **)) or ("class", constructor (kws, **),
    {method: (kws, **)})} of a module's public top-level defs."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("function", _signature(node))
        elif isinstance(node, ast.ClassDef):
            methods = {b.name: _signature(b) for b in node.body
                       if isinstance(b, ast.FunctionDef)
                       and not b.name.startswith("_")}
            ctor = ([], False)
            if _is_dataclass(node):
                ctor = ([b.target.id for b in node.body
                         if isinstance(b, ast.AnnAssign)
                         and isinstance(b.target, ast.Name)], False)
            for b in node.body:
                if isinstance(b, ast.FunctionDef) and b.name == "__init__":
                    kws, var = _signature(b)
                    ctor = (ctor[0] + kws[1:], var)
            out[node.name] = ("class", ctor, methods)
    return out


def _modules():
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py"))


def _gaps() -> list:
    """Every gap of the port against the JAX package, as EXCEPTIONS keys."""
    gaps = []

    def keywords(where, jax_sig, port_sig):
        kws, _ = jax_sig
        port_kws, var = port_sig
        self_free = [k for k in kws if k not in ("self", "cls")]
        gaps.extend(f"{where}({k})" for k in self_free
                    if not var and k not in port_kws)

    for rel in _modules():
        port_path = PORT_PKG / rel
        if not port_path.exists():
            gaps.append(rel)
            continue
        jax_api, port_api = _api(JAX_PKG / rel), _api(port_path)
        for name, entry in jax_api.items():
            key = f"{rel}::{name}"
            if name not in port_api or port_api[name][0] != entry[0]:
                gaps.append(key)
                continue
            if entry[0] == "function":
                keywords(key, entry[1], port_api[name][1])
                continue
            keywords(key, entry[1], port_api[name][1])
            port_methods = port_api[name][2]
            for m, sig in entry[2].items():
                if m not in port_methods:
                    gaps.append(f"{key}.{m}")
                else:
                    keywords(f"{key}.{m}", sig, port_methods[m])
    return gaps


def test_every_jax_module_has_a_port_module():
    missing = [rel for rel in _modules() if not (PORT_PKG / rel).exists()]
    assert not missing, f"modules of spacer_tpu without a port: {missing}"


def test_port_has_every_public_name_and_keyword():
    gaps = [g for g in _gaps() if g not in EXCEPTIONS]
    assert not gaps, (
        "public names / keywords of spacer_tpu the port lacks (port them, "
        f"or add each to EXCEPTIONS with its reason): {gaps}")


def test_exceptions_are_current_and_give_reasons():
    gaps = set(_gaps())
    stale = [k for k in EXCEPTIONS if k not in gaps]
    assert not stale, (
        "exceptions the port no longer needs (it has the name or keyword, "
        f"or the JAX package lost it): {stale}")
    bare = [k for k, why in EXCEPTIONS.items()
            if not isinstance(why, str) or len(why.split()) < 3]
    assert not bare, f"exceptions without a reason: {bare}"


def test_the_parser_sees_the_port_api():
    """The walk reads what it should: a known function's keywords, a
    dataclass's fields and a class's methods, on both sides."""
    rel = "models/qwen25_vl/model.py"
    jax_api, port_api = _api(JAX_PKG / rel), _api(PORT_PKG / rel)
    for api in (jax_api, port_api):
        kind, (kws, _) = api["forward"]
        assert kind == "function"
        assert {"pixel_values", "cache", "cache_index", "attn_impl"} <= set(
            kws)
    cfg = _api(PORT_PKG / "train/sft_trainer.py")["SFTConfig"]
    assert cfg[0] == "class" and "attn_impl" in cfg[1][0]
    sampler = _api(PORT_PKG / "sampler/sampler.py")["Sampler"]
    assert "vision_embeds" in sampler[2]["generate"][0]
    assert "spacer_tpu/" not in "".join(_modules())
    assert len(_modules()) > 50
