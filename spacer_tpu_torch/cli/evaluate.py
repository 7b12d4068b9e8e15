"""Evaluation entry point (SpaceR-Eval/evaluate.py equivalent; counterpart
of spacer_tpu/cli/evaluate.py).

Runs on the card (`--device cuda`, the default) unless given
`--device cpu`.  `--serving static` (the default) decodes each batch of
`--batch_size` prompts in one Sampler.generate; `--serving continuous`
streams them through `--batch_size` decode slots, and with
`--speculate_k K` verifies K prompt-lookup drafts per slot and step
(refused with static serving, before the checkpoint load).

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
    refuse_mesh,
    setup_distributed,
)
from spacer_tpu_torch.utils.config import parse_configs


def main(argv=None):
    from spacer_tpu_torch.evalharness import EvalConfig, QwenEngine, run_benchmark

    eval_cfg, model_args = parse_configs((EvalConfig, ModelArgs), argv)
    if eval_cfg.speculate_k and eval_cfg.serving != "continuous":
        # fail before the checkpoint load with a clear message
        raise SystemExit("--speculate_k requires --serving continuous")
    setup_distributed(model_args)
    cfg, params, processor, mesh = load_model_and_processor(model_args)
    refuse_mesh(mesh, "evaluation")
    engine = QwenEngine(cfg, params, processor,
                        decode_quant=decode_quant_arg(model_args.decode_quant),
                        speculate_k=eval_cfg.speculate_k)
    metrics = run_benchmark(eval_cfg, engine)
    print(json.dumps(metrics, indent=1, default=float))
    return metrics


if __name__ == "__main__":
    main()
