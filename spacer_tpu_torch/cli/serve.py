"""Serving entry point (counterpart of spacer_tpu/cli/serve.py): the
file-in/file-out batch path, or with `--http` the OpenAI-compatible online
server (serving/server.py).

The batch path reads prompts from a jsonl file and writes one completion per
row, through QwenEngine.generate_many (`--serving continuous`, the default:
decode slots with refill) or QwenEngine.generate (`--serving static`: one
grouped Sampler.generate per wave).  Input rows are chat-format
{"messages": [...]} or shorthand {"prompt": "text", "video": "/path.mp4"?,
"image": "/path.png"?}; each output row is the input row plus a
"completion" field.

`--speculate_k K` verifies K prompt-lookup drafts per slot and step
(serving/speculative.py); it needs continuous serving (or --http) and is
refused with `--serving static` before the model is loaded.

Runs on the card (`--device cuda`, the default) unless given
`--device cpu`; `--decode_quant int8_kv|int4_kv|...` quantizes the decode
loop (ops/quant.py).

A model split over a tensor-parallel mesh serves under torchrun with
`--multihost true --tp N`: every rank runs the same batcher steps in
lockstep; rank 0 alone writes the output file, and with `--http` rank 0
alone listens and broadcasts each wave's admissions to the others
(serving/server.py), which follow until it stops.

Examples:
    python -m spacer_tpu_torch.cli.serve --random_init true \\
        --input_file prompts.jsonl --slots 8 --decode_quant int4_kv
    python -m spacer_tpu_torch.cli.serve --random_init true --http \\
        --port 8000 --prompt_len 1024 --speculate_k 4
    torchrun --nproc_per_node 2 -m spacer_tpu_torch.cli.serve \\
        --multihost true --tp 2 --model_name_or_path DIR --input_file x.jsonl
"""

from __future__ import annotations

import dataclasses
import json
import os

from spacer_tpu_torch.cli.common import (
    ModelArgs,
    decode_quant_arg,
    load_model_and_processor,
    serving_params,
    setup_distributed,
)
from spacer_tpu_torch.parallel import multihost
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
    serving: str = "continuous"   # "continuous" | "static"
    # --http: the OpenAI-compatible online server instead of the batch path
    http: bool = False
    host: str = "127.0.0.1"
    port: int = 8000
    prompt_len: int = 1024        # http: the deployment's prompt bucket
    # prompt-lookup speculative decoding: drafts verified per step
    speculate_k: int = 0


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
    if not serve_cfg.http and not serve_cfg.input_file:
        raise SystemExit("--input_file is required (or pass --http)")
    if serve_cfg.serving not in ("continuous", "static"):
        raise SystemExit(f"--serving {serve_cfg.serving!r}: expected "
                         "continuous or static")
    # refused before the (minutes-long) checkpoint load, not on wave 1
    if (serve_cfg.speculate_k and not serve_cfg.http
            and serve_cfg.serving != "continuous"):
        raise SystemExit("--speculate_k requires --serving continuous (the "
                         "static grouped sampler serves without it)")
    setup_distributed(model_args)
    cfg, params, processor, mesh = load_model_and_processor(model_args)
    params = serving_params(params, mesh)
    decode_quant = decode_quant_arg(model_args.decode_quant)
    rank0 = multihost.process_index() == 0

    if serve_cfg.http:
        from spacer_tpu_torch.serving import OpenAIServer

        server = OpenAIServer(
            cfg, params, processor,
            model_name=model_args.model_name_or_path or "spacer",
            slots=serve_cfg.slots, prompt_len=serve_cfg.prompt_len,
            max_new_tokens=serve_cfg.max_new_tokens,
            temperature=serve_cfg.temperature, top_p=serve_cfg.top_p,
            chunk_steps=serve_cfg.chunk_steps, decode_quant=decode_quant,
            speculate_k=serve_cfg.speculate_k, follower=not rank0)
        if not rank0:
            server.follow()
            return None
        print(f"serving {model_args.model_name_or_path or 'model'} on "
              f"http://{serve_cfg.host}:{serve_cfg.port}/v1", flush=True)
        server.serve_forever(serve_cfg.host, serve_cfg.port)
        return None
    engine = QwenEngine(cfg, params, processor, top_p=serve_cfg.top_p,
                        decode_quant=decode_quant,
                        speculate_k=serve_cfg.speculate_k)

    with open(serve_cfg.input_file) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    wave = serve_cfg.wave_size or serve_cfg.slots * 8
    n = 0
    # every rank runs every wave (lockstep); rank 0 writes
    with open(serve_cfg.output_file if rank0 else os.devnull, "w") as out:
        for start in range(0, len(rows), wave):
            batch = rows[start:start + wave]
            messages = [_row_to_messages(r) for r in batch]
            if serve_cfg.serving == "continuous":
                texts = engine.generate_many(
                    messages, max_new_tokens=serve_cfg.max_new_tokens,
                    temperature=serve_cfg.temperature, slots=serve_cfg.slots,
                    chunk_steps=serve_cfg.chunk_steps)
            else:
                texts = engine.generate(
                    messages, max_new_tokens=serve_cfg.max_new_tokens,
                    temperature=serve_cfg.temperature)
            for row, text in zip(batch, texts):
                out.write(json.dumps({**row, "completion": text}) + "\n")
                n += 1
    if rank0:
        print(f"wrote {n} completions to {serve_cfg.output_file}")
    return serve_cfg.output_file


if __name__ == "__main__":
    main()
