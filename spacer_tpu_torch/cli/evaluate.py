"""Evaluation entry point (SpaceR-Eval/evaluate.py equivalent; counterpart
of spacer_tpu/cli/evaluate.py).

Runs on the card (`--device cuda`, the default) unless given
`--device cpu`.  `--serving static` (the default) decodes each batch of
`--batch_size` prompts in one Sampler.generate; `--serving continuous`
streams them through `--batch_size` decode slots.

Example:
    python -m spacer_tpu_torch.cli.evaluate --task VSI-Bench \\
        --model_name_or_path /ckpts/SpaceR --data_root /data \\
        --num_frames 32 --prompt_type thinking
"""

from __future__ import annotations

import json

from spacer_tpu_torch.cli.common import (
    ModelArgs,
    decode_quant_arg,
    load_model_and_processor,
)
from spacer_tpu_torch.utils.config import parse_configs


def main(argv=None):
    from spacer_tpu_torch.evalharness import EvalConfig, QwenEngine, run_benchmark
    from spacer_tpu_torch.evalharness.runner import check_unported

    eval_cfg, model_args = parse_configs((EvalConfig, ModelArgs), argv)
    check_unported(eval_cfg)   # before the checkpoint load
    cfg, params, processor = load_model_and_processor(model_args)
    engine = QwenEngine(cfg, params, processor,
                        decode_quant=decode_quant_arg(model_args.decode_quant))
    metrics = run_benchmark(eval_cfg, engine)
    print(json.dumps(metrics, indent=1, default=float))
    return metrics


if __name__ == "__main__":
    main()
