"""Shared CLI plumbing: model and processor loading (counterpart of
spacer_tpu/cli/common.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ModelArgs:
    model_name_or_path: str = ""       # HF checkpoint dir (safetensors)
    tokenizer_path: str = ""           # defaults to model_name_or_path
    dtype: str = "bfloat16"            # param dtype
    random_init: bool = False          # tiny random model (smoke runs)
    # torch device the model runs on; the CPU only when asked for
    device: str = "cuda"
    # decode-path quantization: "" (bf16) | "int8" | "int8_kv" | "int4" |
    # "int4_kv" (applies to the rollout sampler and the serving batcher)
    decode_quant: str = ""


def decode_quant_arg(value) -> str | None:
    """The CLI spelling of "no quantization" ("", "none", None) -> None;
    anything else is passed on (and validated where it is used)."""
    if value is None or str(value).lower() in ("", "none"):
        return None
    return str(value)


def load_tokenizer(path: str):
    """The checkpoint's tokenizer through transformers.AutoTokenizer (the
    one import of transformers in the port)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {path!r} needs the transformers "
            "package, which cannot be imported here; install it, or run "
            "with --random_init true (MockTokenizer)") from e
    return AutoTokenizer.from_pretrained(path)


def load_model_and_processor(args: ModelArgs):
    """Returns (cfg, params, processor): the checkpoint at
    `model_name_or_path` loaded onto `device` with its tokenizer, or with
    `random_init` (or no path) the tiny random model and MockTokenizer."""
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.models.registry import get_family

    device = torch.device(args.device)
    # the entry points never carry on on the CPU unless told to
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: CUDA is not available on this host; "
            "pass --device cpu to run on the CPU")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    if args.random_init or not args.model_name_or_path:
        cfg = tiny_config()
        params = init_params(cfg, seed=0, dtype=dtype, device=device)
        tokenizer = MockTokenizer(vocab_size=cfg.text.vocab_size)
    else:
        family = get_family(args.model_name_or_path)
        params, cfg = family.load_params_from_hf(
            args.model_name_or_path, dtype=dtype, device=device)
        tokenizer = load_tokenizer(args.tokenizer_path
                                   or args.model_name_or_path)
    return cfg, params, VLProcessor(tokenizer, cfg, device=device)
