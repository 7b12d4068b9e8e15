"""Aria, the MoE vision-language family, in PyTorch: the Idefics3 ViT and
perceiver projector + the MoE decoder (image-only, as in the reference)."""

from spacer_tpu_torch.models.aria.config import (
    ARIA_25B,
    AriaConfig,
    AriaTextConfig,
    AriaVisionConfig,
    tiny_aria_config,
)
from spacer_tpu_torch.models.aria.language import (
    init_kv_cache,
    init_lm_params,
    positions_1d_to_3d,
)
from spacer_tpu_torch.models.aria.loading import (
    config_to_hf_dict,
    export_to_safetensors,
    load_params_from_hf,
    params_from_torch_state_dict,
)
from spacer_tpu_torch.models.aria.model import (
    encode_vision,
    forward,
    init_params,
    lm_forward,
    make_kv_cache,
    merge_vision_embeds,
)
from spacer_tpu_torch.models.aria.vision import (
    projector_forward,
    vision_position_ids,
    vit_forward,
)

__all__ = [
    "ARIA_25B", "AriaConfig", "AriaTextConfig", "AriaVisionConfig",
    "tiny_aria_config", "init_kv_cache", "init_lm_params",
    "positions_1d_to_3d", "config_to_hf_dict", "export_to_safetensors",
    "load_params_from_hf", "params_from_torch_state_dict", "encode_vision",
    "forward", "init_params", "lm_forward", "make_kv_cache",
    "merge_vision_embeds", "projector_forward", "vision_position_ids",
    "vit_forward",
]
