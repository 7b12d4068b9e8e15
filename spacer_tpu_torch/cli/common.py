"""Shared CLI plumbing: model and processor loading, mesh setup
(counterpart of spacer_tpu/cli/common.py)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch


@dataclasses.dataclass
class ModelArgs:
    model_name_or_path: str = ""       # HF checkpoint dir (safetensors)
    tokenizer_path: str = ""           # defaults to model_name_or_path
    dtype: str = "bfloat16"            # param dtype
    random_init: bool = False          # tiny random model (smoke runs)
    # model family override; empty = dispatch on the model id substring
    # (the reference's "Aria" in model_id rule)
    model_family: str = ""
    # torch device the model runs on; the CPU only when asked for
    device: str = "cuda"
    tp: int = 1                        # tensor-parallel axis size
    fsdp: Optional[int] = None         # fsdp axis size (default: all)
    # join torchrun's process group (NCCL on CUDA, gloo on --device cpu)
    multihost: bool = False
    # decode-path quantization: "" (bf16) | "int8" | "int8_kv" | "int4" |
    # "int4_kv" (applies to the rollout sampler and the serving batcher)
    decode_quant: str = ""


def decode_quant_arg(value) -> str | None:
    """The CLI spelling of "no quantization" ("", "none", None) -> None;
    anything else is passed on (and validated where it is used)."""
    if value is None or str(value).lower() in ("", "none"):
        return None
    return str(value)


def remat_arg(value):
    """The CLI spelling of a remat mode: "true" / "false" (any case, or
    1 / 0) -> bool; anything else is passed on as the mode's name, which
    check_remat validates where the step is built."""
    if isinstance(value, str) and value.lower() in ("true", "1", "false", "0"):
        return value.lower() in ("true", "1")
    return value


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


def setup_distributed(args: ModelArgs):
    """--multihost true: join torchrun's process group (one process per
    device; parallel/multihost.initialize), which must exist, and leave it
    when the process exits (multihost.shutdown, before the interpreter
    tears down: a gloo group left to the interpreter's teardown can abort a
    process whose work is done, "terminate called without an active
    exception")."""
    if not args.multihost:
        return
    import atexit

    from spacer_tpu_torch.parallel import multihost

    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--multihost true runs under torchrun (its RANK, "
                           "WORLD_SIZE and MASTER_ADDR / MASTER_PORT "
                           "environment was not found)")
    multihost.initialize(device=args.device)
    atexit.register(multihost.shutdown)


def serving_params(params, mesh):
    """The params serving and evaluation run on: over a mesh, the fsdp
    shards gathered once (serving holds no optimizer state; tp slices stay
    slices), so every batch group computes the same batch with the tp
    group's collectives only (JAX gathers on use instead: ROADMAP queue
    C).  Under moe_impl "ep" the experts stay on their owners
    (parallel/expert.py) and each MoE layer exchanges over the ep group
    (cfg.moe_ep_axis: fsdp, data or data x fsdp)."""
    if mesh is None:
        return params
    from spacer_tpu_torch.parallel.fsdp import gather_params

    return gather_params(params)


def load_model_and_processor(args: ModelArgs):
    """Returns (cfg, params, processor, mesh) of the family `model_family`
    names (or, empty, that the model id names): the checkpoint at
    `model_name_or_path` loaded onto `device` with its tokenizer, or with
    `random_init` (or no path) the family's tiny random model and mock
    tokenizer.  Over more than one process (setup_distributed) the params
    are sharded onto a (data, fsdp, tp) mesh (`tp` ranks the fastest axis)
    by the family's partition rules and tp plan; the mesh is None in a
    single process, as JAX gives None on one device."""
    from spacer_tpu_torch.models.registry import get_family
    from spacer_tpu_torch.parallel import multihost

    family = get_family(args.model_family or args.model_name_or_path)
    device = torch.device(args.device)
    # the entry points never carry on on the CPU unless told to
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: CUDA is not available on this host; "
            "pass --device cpu to run on the CPU")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    if args.random_init or not args.model_name_or_path:
        cfg = family.tiny_config()
        params = family.init_params(cfg, seed=0, dtype=dtype, device=device)
        tokenizer = family.mock_tokenizer(cfg.text.vocab_size)
    else:
        params, cfg = family.load_params_from_hf(
            args.model_name_or_path, dtype=dtype, device=device)
        tokenizer = load_tokenizer(args.tokenizer_path
                                   or args.model_name_or_path)
    processor = family.make_processor(tokenizer, cfg, device)
    mesh = None
    if multihost.process_count() > 1 or args.tp > 1:
        from spacer_tpu_torch.parallel.partition import shard_params

        mesh = multihost.global_mesh(tp=args.tp, fsdp=args.fsdp)
        params, _ = shard_params(params, mesh, family.partition_rules,
                                 family.tp_plan(cfg, args.tp))
    return cfg, params, processor, mesh
