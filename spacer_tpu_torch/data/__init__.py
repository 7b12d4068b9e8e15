"""Chat templating and multimodal processing (counterpart of spacer_tpu/data)."""

from spacer_tpu_torch.data.processor import (
    MockTokenizer,
    VLProcessor,
    pack_vision_inputs,
    render_chat_template,
)

__all__ = ["MockTokenizer", "VLProcessor", "pack_vision_inputs",
           "render_chat_template"]
