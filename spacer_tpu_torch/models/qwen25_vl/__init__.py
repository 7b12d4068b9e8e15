"""Qwen2.5-VL in PyTorch: windowed-attention ViT + M-RoPE language model."""

from spacer_tpu_torch.models.qwen25_vl.config import (
    QWEN25_VL_7B,
    Qwen25VLConfig,
    TextConfig,
    VisionConfig,
    tiny_config,
)
from spacer_tpu_torch.models.qwen25_vl.convert import params_from_jax
from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
from spacer_tpu_torch.models.qwen25_vl.loading import (
    export_to_safetensors,
    load_params_from_hf,
    params_from_torch_state_dict,
)
from spacer_tpu_torch.models.qwen25_vl.model import (
    encode_vision,
    init_params,
    merge_vision_embeds,
)
from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

__all__ = [
    "QWEN25_VL_7B", "Qwen25VLConfig", "TextConfig", "VisionConfig",
    "tiny_config", "params_from_jax", "lm_forward", "encode_vision",
    "init_params", "merge_vision_embeds", "get_rope_index",
    "load_params_from_hf", "params_from_torch_state_dict",
    "export_to_safetensors",
]
