"""Qwen2.5-VL and Qwen2-VL in PyTorch: the ViT (windowed or full attention) +
M-RoPE language model."""

from spacer_tpu_torch.models.qwen25_vl.config import (
    QWEN2_VL_7B,
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
    forward,
    init_params,
    make_kv_cache,
    merge_vision_embeds,
)
from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

__all__ = [
    "QWEN2_VL_7B", "QWEN25_VL_7B", "Qwen25VLConfig", "TextConfig", "VisionConfig",
    "tiny_config", "params_from_jax", "lm_forward", "encode_vision",
    "init_params", "merge_vision_embeds", "forward", "make_kv_cache",
    "get_rope_index",
    "load_params_from_hf", "params_from_torch_state_dict",
    "export_to_safetensors",
]
