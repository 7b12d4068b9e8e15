"""Offline batch serving entry point (counterpart of spacer_tpu/cli/serve.py,
continuous-batching file-in/file-out path).

Reads prompts from a jsonl file, streams them through
QwenEngine.generate_many and writes one completion per row.  Input rows are
chat-format {"messages": [...]} or shorthand {"prompt": "text",
"video": "/path.mp4"?, "image": "/path.png"?}; each output row is the
input row plus a "completion" field.

Runs on the card (`--device cuda`, the default) unless given
`--device cpu`; `--decode_quant int8_kv|int4_kv|...` quantizes the decode
loop (ops/quant.py).

Example:
    python -m spacer_tpu_torch.cli.serve --random_init true \\
        --input_file prompts.jsonl --slots 8 --decode_quant int4_kv
"""

from __future__ import annotations

import dataclasses
import json

from spacer_tpu_torch.cli.common import (
    ModelArgs,
    decode_quant_arg,
    load_model_and_processor,
)
from spacer_tpu_torch.utils.config import parse_configs


@dataclasses.dataclass
class ServeConfig:
    input_file: str = ""
    output_file: str = "completions.jsonl"
    max_new_tokens: int = 128
    temperature: float = 0.01
    top_p: float = 1.0
    slots: int = 4
    chunk_steps: int = 32
    # rows per generate_many call (bounds host-side frame memory);
    # 0 = 8 * slots
    wave_size: int = 0


def _row_to_messages(row: dict) -> list:
    if "messages" in row:
        return row["messages"]
    content = []
    if row.get("video"):
        content.append({"type": "video", "video": row["video"]})
    if row.get("image"):
        content.append({"type": "image", "image": row["image"]})
    content.append({"type": "text", "text": row.get("prompt", "")})
    return [{"role": "user", "content": content}]


def main(argv=None):
    from spacer_tpu_torch.evalharness.engine import QwenEngine

    serve_cfg, model_args = parse_configs((ServeConfig, ModelArgs), argv)
    if not serve_cfg.input_file:
        raise SystemExit("--input_file is required")
    cfg, params, processor = load_model_and_processor(model_args)
    engine = QwenEngine(cfg, params, processor, top_p=serve_cfg.top_p,
                        decode_quant=decode_quant_arg(model_args.decode_quant))

    with open(serve_cfg.input_file) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    wave = serve_cfg.wave_size or serve_cfg.slots * 8
    n = 0
    with open(serve_cfg.output_file, "w") as out:
        for start in range(0, len(rows), wave):
            batch = rows[start:start + wave]
            texts = engine.generate_many(
                [_row_to_messages(r) for r in batch],
                max_new_tokens=serve_cfg.max_new_tokens,
                temperature=serve_cfg.temperature, slots=serve_cfg.slots,
                chunk_steps=serve_cfg.chunk_steps)
            for row, text in zip(batch, texts):
                out.write(json.dumps({**row, "completion": text}) + "\n")
                n += 1
    print(f"wrote {n} completions to {serve_cfg.output_file}")
    return serve_cfg.output_file


if __name__ == "__main__":
    main()
