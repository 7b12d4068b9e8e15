"""SG-RLVR training entry point (counterpart of
spacer_tpu/cli/train_sg_rlvr.py).

Example (random tiny weights; `--model_name_or_path DIR` loads an HF
checkpoint instead, cli/common.py):
    python -m spacer_tpu_torch.cli.train_sg_rlvr --random_init true \\
        --dataset_name SpaceR-151k.jsonl \\
        --cognitive_map_path annotation/cognitive_map.jsonl \\
        --output_dir output/sg_rlvr

Runs on the card (`--device cuda`, the default) unless given
`--device cpu`; under torchrun with `--multihost true` over a (data,
fsdp, tp) mesh of the world (`--tp`, `--fsdp`; cli/common.py).  Rollouts
decode at `--decode_quant`, by default the trainer's "int8_kv"; `none`
(or "") gives bf16 rollouts.
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


@dataclasses.dataclass
class ScriptArgs:
    dataset_name: str = "SpaceR-151k.jsonl"
    cognitive_map_path: str = "annotation/cognitive_map.jsonl"
    reward_funcs: tuple = ("accuracy", "format")
    resume_from_checkpoint: Optional[str] = None
    max_rows: Optional[int] = None


def main(argv=None):
    from spacer_tpu_torch.data import (
        load_cognitive_maps,
        load_jsonl_dataset,
        make_conversation,
    )
    from spacer_tpu_torch.rewards import get_reward_funcs
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
    map_data = load_cognitive_maps(script.cognitive_map_path)
    dataset = [{**r, **make_conversation(r, map_data)} for r in rows]

    trainer = SGRLVRTrainer(
        cfg, params, processor, get_reward_funcs(list(script.reward_funcs)),
        dataset, train_cfg, map_data=map_data, mesh=mesh)
    trainer.train(resume_from_checkpoint=script.resume_from_checkpoint)
    trainer.save_checkpoint(train_cfg.output_dir + "/final")


if __name__ == "__main__":
    main()
