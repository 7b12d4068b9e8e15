"""Plain video-GRPO entry point (counterpart of spacer_tpu/cli/train_grpo.py;
grpo.py equivalent: simpler rewards, no cognitive-map bonus; MC exact match
and numerical MRA only, grpo.py:65-178).

Example (random tiny weights, on the CPU):
    python -m spacer_tpu_torch.cli.train_grpo --random_init true \\
        --dataset_name train.jsonl --output_dir output/grpo --device cpu

Runs on the card (`--device cuda`, the default) unless given `--device
cpu`; every SGRLVRConfig field is a flag (`--gradient_accumulation_steps`,
`--offload_opt_state`, `--remat dots_narrow`, ...).  Under torchrun with
`--multihost true`, `--tp N` splits each model copy over N ranks, Aria's
too (`--model_family aria`; SPACER_MOE_IMPL=ep places its experts by
expert over the fsdp ranks: spacer_tpu_torch/scripts/run_aria_moe.sh).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spacer_tpu_torch.cli.common import (
    ModelArgs,
    decode_quant_arg,
    load_model_and_processor,
    setup_distributed,
    remat_arg,
)
from spacer_tpu_torch.utils.config import parse_configs


def grpo_accuracy_reward(completions, solution, **kwargs):
    """grpo.py:65-178 variant: only MC / numerical types score; everything
    else (OCR, free-form, regression) is 0.0."""
    from spacer_tpu_torch.rewards.accuracy import accuracy_reward

    qtype = kwargs["problem_type"][0]
    if qtype not in ("multiple choice", "numerical"):
        return [0.0] * len(completions)
    kwargs.pop("map_data", None)
    return accuracy_reward(completions, solution, map_data=None, **kwargs)


@dataclasses.dataclass
class ScriptArgs:
    dataset_name: str = "dataset.jsonl"
    reward_funcs: tuple = ("accuracy", "format")
    resume_from_checkpoint: Optional[str] = None
    max_rows: Optional[int] = None


def main(argv=None):
    from spacer_tpu_torch.data import load_jsonl_dataset, make_conversation
    from spacer_tpu_torch.rewards.format import format_reward
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    script, train_cfg, model_args = parse_configs(
        (ScriptArgs, SGRLVRConfig, ModelArgs), argv)
    train_cfg.decode_quant = decode_quant_arg(train_cfg.decode_quant)
    train_cfg.remat = remat_arg(train_cfg.remat)
    setup_distributed(model_args)
    cfg, params, processor, mesh = load_model_and_processor(model_args)

    rows = load_jsonl_dataset(script.dataset_name)
    if script.max_rows:
        rows = rows[:script.max_rows]
    dataset = [{**r, **make_conversation(r, None)} for r in rows]

    registry = {"accuracy": grpo_accuracy_reward, "format": format_reward}
    reward_funcs = [registry[n] for n in script.reward_funcs]

    trainer = SGRLVRTrainer(cfg, params, processor, reward_funcs, dataset,
                            train_cfg, map_data=None, mesh=mesh)
    trainer.train(resume_from_checkpoint=script.resume_from_checkpoint)
    trainer.save_checkpoint(train_cfg.output_dir + "/final")


if __name__ == "__main__":
    main()
