"""Model publishing: HF-layout export and push_to_hub (counterpart of
spacer_tpu/train/publish.py).

Reference conventions:
  - SG-RLVR.py:383-386  trainer.save_model(output_dir); if push_to_hub:
    trainer.push_to_hub(...)
  - sft.py:260-266      the processor is saved ALONGSIDE the model, and the
    saved config has use_cache=True.

The artifact is an HF-layout directory: model.safetensors and config.json,
written by the family's `export_to_safetensors` (models/qwen25_vl/loading.py
or models/aria/loading.py, whose `load_params_from_hf` reads it back), plus
the processor / tokenizer files of a source checkpoint.  `push_to_hub`
uploads it through huggingface_hub, imported at call time: where the
package is missing it raises with what to do instead.
"""

from __future__ import annotations

import json
import os
import shutil

# files the HF processor convention saves alongside the model
# (AutoProcessor.save_pretrained's output for Qwen2.5-VL)
_PROCESSOR_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "vocab.json",
    "merges.txt",
    "special_tokens_map.json",
    "added_tokens.json",
    "preprocessor_config.json",
    "processor_config.json",
    "chat_template.json",
    "chat_template.jinja",
)


def save_pretrained(out_dir: str, params, cfg,
                    processor_dir: str | None = None) -> str:
    """Write an HF-layout model directory: model.safetensors (each tensor
    in the params' dtype), config.json (use_cache forced True, torch_dtype
    the params'), and the processor files found in `processor_dir` (never
    its weights)."""
    from spacer_tpu_torch.models.registry import family_for_config

    if family_for_config(cfg).name == "aria":
        from spacer_tpu_torch.models.aria.loading import export_to_safetensors
    else:
        from spacer_tpu_torch.models.qwen25_vl.loading import (
            export_to_safetensors,
        )
    export_to_safetensors(params, cfg, out_dir)
    path = os.path.join(out_dir, "config.json")
    with open(path) as f:
        hf_cfg = json.load(f)
    # training runs without a KV cache; the published model must not
    hf_cfg["use_cache"] = True
    with open(path, "w") as f:
        json.dump(hf_cfg, f, indent=2)
    if processor_dir:
        for name in _PROCESSOR_FILES:
            src = os.path.join(processor_dir, name)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(out_dir, name))
    return out_dir


def push_to_hub(repo_id: str, folder: str, *, token: str | None = None,
                private: bool = True, api=None) -> str:
    """Upload a saved model directory to the Hugging Face Hub.  `api`
    injects an HfApi-compatible object (tests); by default huggingface_hub
    is imported here, so installs without it pay only when publishing."""
    if not repo_id:
        raise ValueError("push_to_hub needs a repo id (hub_model_id)")
    if api is None:
        try:
            from huggingface_hub import HfApi
        except ImportError as e:
            raise RuntimeError(
                "push_to_hub requires the huggingface_hub package; install "
                "it or publish the directory by hand (the artifact is "
                f"complete at {folder})") from e
        api = HfApi(token=token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(repo_id=repo_id, folder_path=folder)
    return repo_id
