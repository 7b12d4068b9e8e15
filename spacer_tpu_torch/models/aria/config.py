# Copied from spacer_tpu/models/aria/config.py (numpy / stdlib only; no JAX).
"""Aria model configuration (mirrors HF configuration_aria.py).

Aria (rhymes-ai/Aria) is the MoE vision-language family dispatched by the
reference trainer when "Aria" is in the model id
(SpaceR-SG-RLVR/src/r1-v/src/open_r1/trainer/grpo_trainer.py:200-202,
:224-225).  Text model: Llama-style decoder whose feed-forward is a
top-k-routed mixture of grouped experts plus shared experts
(modeling_aria.py AriaTextMoELayer).  Vision: an Idefics3/SigLIP ViT and a
perceiver-style cross-attention projector (AriaProjector).

The text config duck-types the Qwen TextConfig contract used by the shared
decoder engine (models/qwen25_vl/language.py): plain 1D RoPE is expressed
as mrope_section = (head_dim//2, 0, 0) with all three position rows equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AriaTextConfig:
    vocab_size: int = 100352
    hidden_size: int = 2560
    intermediate_size: int = 1664          # per-expert (moe) intermediate
    num_layers: int = 28
    num_heads: int = 20
    num_kv_heads: int = 20
    rms_norm_eps: float = 1e-5
    rope_theta: float = 5000000.0
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 65536
    attention_bias: bool = False
    moe_num_experts: int = 64
    moe_topk: int = 6
    moe_num_shared_experts: int = 2
    # "ragged": dropless grouped GEMM (weights ZeRO-gathered on use);
    # "ep": expert-parallel capacity dispatch (weights stay put, tokens
    # all-to-all over moe_ep_axis); None: env/default.
    moe_impl: str | None = None
    moe_capacity_factor: float = 2.0
    moe_ep_axis: str | tuple = "fsdp"

    def __post_init__(self):
        # Resolve the SPACER_MOE_IMPL env override HERE, on the host, at
        # config construction — an os.environ read inside the jit-traced
        # MLP would be baked in at first trace and never again consulted.
        if self.moe_impl is None:
            import os

            env = os.environ.get("SPACER_MOE_IMPL")
            if env:
                object.__setattr__(self, "moe_impl", env)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mrope_section(self) -> tuple[int, ...]:
        # plain 1D RoPE through the shared M-RoPE path: the full rotary
        # half comes from axis 0; axes 1/2 contribute zero channels.
        return (self.head_dim // 2, 0, 0)


@dataclasses.dataclass(frozen=True)
class AriaVisionConfig:
    """Idefics3VisionConfig geometry (modeling_idefics3.py:104-190)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    num_channels: int = 3
    patch_size: int = 14
    image_size: int = 980
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class AriaConfig:
    text: AriaTextConfig = dataclasses.field(default_factory=AriaTextConfig)
    vision: AriaVisionConfig = dataclasses.field(
        default_factory=AriaVisionConfig)
    image_token_id: int = 9
    # patches -> learned query count for the projector
    # (AriaProjector.patch_to_query_dict; 980px/14 -> 4900, 490px/14 -> 1225)
    projector_patch_to_query: tuple[tuple[int, int], ...] = (
        (1225, 128), (4900, 256),
    )
    max_projector_queries: int = 256
    eos_token_id: int = 2
    pad_token_id: int = 2

    @property
    def patch_to_query(self) -> dict[int, int]:
        return dict(self.projector_patch_to_query)

    @classmethod
    def from_hf_config(cls, hf) -> "AriaConfig":
        """Build from a transformers AriaConfig instance or dict."""
        d = hf if isinstance(hf, dict) else hf.to_dict()
        t = d.get("text_config", {})
        v = d.get("vision_config", {})
        text = AriaTextConfig(
            vocab_size=t.get("vocab_size", 100352),
            hidden_size=t.get("hidden_size", 2560),
            intermediate_size=t.get("intermediate_size", 1664),
            num_layers=t.get("num_hidden_layers", 28),
            num_heads=t.get("num_attention_heads", 20),
            num_kv_heads=t.get("num_key_value_heads",
                               t.get("num_attention_heads", 20)),
            rms_norm_eps=t.get("rms_norm_eps", 1e-5),
            rope_theta=t.get("rope_theta", 5000000.0),
            tie_word_embeddings=t.get("tie_word_embeddings", False),
            max_position_embeddings=t.get("max_position_embeddings", 65536),
            attention_bias=t.get("attention_bias", False),
            moe_num_experts=t.get("moe_num_experts", 64),
            moe_topk=t.get("moe_topk", 6),
            moe_num_shared_experts=t.get("moe_num_shared_experts", 2),
        )
        vision = AriaVisionConfig(
            hidden_size=v.get("hidden_size", 1152),
            intermediate_size=v.get("intermediate_size", 4304),
            num_layers=v.get("num_hidden_layers", 27),
            num_heads=v.get("num_attention_heads", 16),
            num_channels=v.get("num_channels", 3),
            patch_size=v.get("patch_size", 14),
            image_size=v.get("image_size", 980),
            layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        )
        p2q = d.get("projector_patch_to_query_dict")
        kw = {}
        if p2q:
            kw["projector_patch_to_query"] = tuple(
                sorted((int(k), int(val)) for k, val in p2q.items())
            )
            kw["max_projector_queries"] = d.get(
                "max_value_projector_patch_to_query_dict",
                max(int(val) for val in p2q.values()),
            )
        return cls(
            text=text, vision=vision,
            image_token_id=d.get("image_token_index", 9),
            **kw,
        )


ARIA_25B = AriaConfig()


def tiny_aria_config(vocab_size: int = 1024) -> AriaConfig:
    """A parity-test-sized Aria (same structure, tiny dims)."""
    return AriaConfig(
        text=AriaTextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=32,
            num_layers=2,
            num_heads=4,
            num_kv_heads=4,
            rope_theta=10000.0,
            max_position_embeddings=512,
            moe_num_experts=8,
            moe_topk=2,
            moe_num_shared_experts=2,
        ),
        vision=AriaVisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=2,
            patch_size=14,
            image_size=56,          # 4x4 patches per image
        ),
        image_token_id=9,
        projector_patch_to_query=((16, 8),),
        max_projector_queries=8,
        eos_token_id=2,
        pad_token_id=2,
    )
