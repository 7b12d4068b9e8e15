# Copied from spacer_tpu/models/qwen25_vl/config.py (numpy / stdlib only; no JAX).
"""Qwen2.5-VL model configuration (mirrors HF configuration_qwen2_5_vl.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    tokens_per_second: int = 2
    rope_theta: float = 10000.0
    # "qwen2_5": RMSNorm + SwiGLU + windowed attention (Qwen2.5-VL)
    # "qwen2":   LayerNorm + fc1/quick_gelu/fc2 + full attention (Qwen2-VL)
    arch: str = "qwen2_5"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 128000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645  # <|im_end|> (chat models)
    pad_token_id: int = 151643  # <|endoftext|>

    @classmethod
    def from_hf_config(cls, hf) -> "Qwen25VLConfig":
        """Build from a transformers Qwen2_5_VLConfig instance or dict."""
        if isinstance(hf, dict):
            d = hf
            v = d.get("vision_config", {})
            t = d.get("text_config", d)
        else:
            d = hf.to_dict()
            v = d.get("vision_config", {})
            t = d.get("text_config", d)
        text = TextConfig(
            vocab_size=t.get("vocab_size", 152064),
            hidden_size=t.get("hidden_size", 3584),
            intermediate_size=t.get("intermediate_size", 18944),
            num_layers=t.get("num_hidden_layers", 28),
            num_heads=t.get("num_attention_heads", 28),
            num_kv_heads=t.get("num_key_value_heads", 4),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1000000.0),
            mrope_section=tuple(
                (t.get("rope_scaling") or {}).get("mrope_section", (16, 24, 24))
            ),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            max_position_embeddings=t.get("max_position_embeddings", 128000),
        )
        if "embed_dim" in v or v.get("model_type") == "qwen2_vl":
            # Qwen2-VL vision config layout (configuration_qwen2_vl.py)
            depth = v.get("depth", 32)
            vision = VisionConfig(
                arch="qwen2",
                depth=depth,
                hidden_size=v.get("embed_dim", 1280),
                intermediate_size=int(
                    v.get("embed_dim", 1280) * v.get("mlp_ratio", 4)
                ),
                num_heads=v.get("num_heads", 16),
                in_channels=v.get("in_channels", 3),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=v.get("temporal_patch_size", 2),
                spatial_merge_size=v.get("spatial_merge_size", 2),
                fullatt_block_indexes=tuple(range(depth)),
                out_hidden_size=v.get("hidden_size", 3584),
                tokens_per_second=1,
            )
        else:
            vision = VisionConfig(
                depth=v.get("depth", 32),
                hidden_size=v.get("hidden_size", 1280),
                intermediate_size=v.get("intermediate_size", 3420),
                num_heads=v.get("num_heads", 16),
                in_channels=v.get("in_channels", 3),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=v.get("temporal_patch_size", 2),
                spatial_merge_size=v.get("spatial_merge_size", 2),
                window_size=v.get("window_size", 112),
                fullatt_block_indexes=tuple(
                    v.get("fullatt_block_indexes", (7, 15, 23, 31))
                ),
                out_hidden_size=v.get("out_hidden_size", 3584),
                tokens_per_second=v.get("tokens_per_second", 2),
            )
        return cls(
            text=text,
            vision=vision,
            image_token_id=d.get("image_token_id", 151655),
            video_token_id=d.get("video_token_id", 151656),
            vision_start_token_id=d.get("vision_start_token_id", 151652),
            vision_end_token_id=d.get("vision_end_token_id", 151653),
        )


QWEN25_VL_7B = Qwen25VLConfig()

# Qwen2-VL-7B-Instruct: same LM geometry, full-attention quick-gelu ViT,
# tokens_per_second 1 (configuration_qwen2_vl.py defaults)
QWEN2_VL_7B = Qwen25VLConfig(
    vision=VisionConfig(
        arch="qwen2",
        depth=32,
        hidden_size=1280,
        intermediate_size=1280 * 4,   # mlp_ratio 4
        num_heads=16,
        fullatt_block_indexes=tuple(range(32)),
        out_hidden_size=3584,
        tokens_per_second=1,
    ),
)

QWEN25_VL_3B = Qwen25VLConfig(
    text=TextConfig(
        vocab_size=151936,
        hidden_size=2048,
        intermediate_size=11008,
        num_layers=36,
        num_heads=16,
        num_kv_heads=2,
        tie_word_embeddings=True,
    ),
    vision=VisionConfig(out_hidden_size=2048),
)


def tiny_config(vocab_size: int = 1024, arch: str = "qwen2_5") -> Qwen25VLConfig:
    """A parity-test-sized config (same structure, tiny dims)."""
    if arch == "qwen2":
        vision = VisionConfig(
            arch="qwen2",
            depth=4,
            hidden_size=32,
            intermediate_size=128,  # mlp_ratio 4
            num_heads=2,
            fullatt_block_indexes=(0, 1, 2, 3),
            out_hidden_size=64,
            tokens_per_second=1,
        )
    else:
        vision = VisionConfig(
            depth=4,
            hidden_size=32,
            intermediate_size=64,
            num_heads=2,
            fullatt_block_indexes=(1, 3),
            out_hidden_size=64,
            window_size=112,
        )
    return Qwen25VLConfig(
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            mrope_section=(4, 2, 2),  # sums to head_dim/2 = 8
        ),
        vision=vision,
        image_token_id=6,
        video_token_id=7,
        vision_start_token_id=4,
        vision_end_token_id=5,
        eos_token_id=2,
        pad_token_id=0,
    )
