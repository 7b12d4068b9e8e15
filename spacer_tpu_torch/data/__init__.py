"""Chat templating, multimodal processing and dataset loading (counterpart
of spacer_tpu/data)."""

from spacer_tpu_torch.data.aria_processor import (
    AriaProcessor,
    MockAriaTokenizer,
)
from spacer_tpu_torch.data.dataset import (
    load_cognitive_maps,
    load_jsonl_dataset,
    read_data,
)
from spacer_tpu_torch.data.processor import (
    MockTokenizer,
    VLProcessor,
    pack_vision_inputs,
    render_chat_template,
)
from spacer_tpu_torch.data.templates import (
    COGMAP_TEMPLATE,
    EXAMPLE_MAP,
    QUESTION_TEMPLATE,
    SYSTEM_PROMPT,
    TYPE_TEMPLATE,
    make_conversation,
)

__all__ = ["AriaProcessor", "MockAriaTokenizer", "MockTokenizer",
           "VLProcessor", "pack_vision_inputs",
           "render_chat_template", "SYSTEM_PROMPT", "QUESTION_TEMPLATE",
           "COGMAP_TEMPLATE", "TYPE_TEMPLATE", "EXAMPLE_MAP",
           "make_conversation", "load_jsonl_dataset", "load_cognitive_maps",
           "read_data"]
