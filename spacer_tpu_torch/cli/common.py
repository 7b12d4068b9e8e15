"""Shared CLI plumbing: model and processor loading (counterpart of
spacer_tpu/cli/common.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ModelArgs:
    model_name_or_path: str = ""       # HF checkpoint dir (not ported yet)
    dtype: str = "bfloat16"            # param dtype
    random_init: bool = False          # tiny random model (smoke runs)
    device: str = "cpu"                # torch device the model runs on


def load_model_and_processor(args: ModelArgs):
    """Returns (cfg, params, processor)."""
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config

    if not args.random_init and args.model_name_or_path:
        raise NotImplementedError(
            "loading HF safetensors checkpoints is not ported yet; "
            "pass --random_init true")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    cfg = tiny_config()
    params = init_params(cfg, seed=0, dtype=dtype, device=args.device)
    tokenizer = MockTokenizer(vocab_size=cfg.text.vocab_size)
    return cfg, params, VLProcessor(tokenizer, cfg, device=args.device)
