"""Evaluation entry point (SpaceR-Eval/evaluate.py equivalent; counterpart
of spacer_tpu/cli/evaluate.py).

Runs on the card (`--device cuda`, the default) unless given
`--device cpu`.  `--serving static` (the default) decodes each batch of
`--batch_size` prompts in one Sampler.generate; `--serving continuous`
streams them through `--batch_size` decode slots, and with
`--speculate_k K` verifies K prompt-lookup drafts per slot and step
(refused with static serving, before the checkpoint load).

Over a tensor-parallel mesh it runs under torchrun with `--multihost
true --tp N`: every rank evaluates the same rows in lockstep, rank 0 alone
writes the shard files, the merged results and the metrics.

Example:
    python -m spacer_tpu_torch.cli.evaluate --task VSI-Bench \\
        --model_name_or_path /ckpts/SpaceR --data_root /data \\
        --num_frames 32 --prompt_type thinking
    torchrun --nproc_per_node 2 -m spacer_tpu_torch.cli.evaluate \\
        --multihost true --tp 2 --task LongVideoBench ...
"""

from __future__ import annotations

import json

from spacer_tpu_torch.cli.common import (
    ModelArgs,
    decode_quant_arg,
    load_model_and_processor,
    serving_params,
    setup_distributed,
)
from spacer_tpu_torch.parallel import multihost
from spacer_tpu_torch.utils.config import parse_configs


def main(argv=None):
    from spacer_tpu_torch.evalharness import EvalConfig, QwenEngine, run_benchmark

    eval_cfg, model_args = parse_configs((EvalConfig, ModelArgs), argv)
    if eval_cfg.speculate_k and eval_cfg.serving != "continuous":
        # fail before the checkpoint load with a clear message
        raise SystemExit("--speculate_k requires --serving continuous")
    setup_distributed(model_args)
    cfg, params, processor, mesh = load_model_and_processor(model_args)
    engine = QwenEngine(cfg, serving_params(params, mesh), processor,
                        decode_quant=decode_quant_arg(model_args.decode_quant),
                        speculate_k=eval_cfg.speculate_k)
    # over a mesh every rank runs the same rows in lockstep; rank 0 writes
    metrics = run_benchmark(eval_cfg, engine)
    if multihost.process_index() == 0:
        print(json.dumps(metrics, indent=1, default=float))
    return metrics


if __name__ == "__main__":
    main()
