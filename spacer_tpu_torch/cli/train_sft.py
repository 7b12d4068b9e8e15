"""SFT entry point (counterpart of spacer_tpu/cli/train_sft.py; sft.py
equivalent).

Example (random tiny weights, on the CPU):
    python -m spacer_tpu_torch.cli.train_sft --random_init true \\
        --dataset_name sft.jsonl --output_dir output/sft --device cpu

Runs on the card (`--device cuda`, the default) unless given `--device
cpu`; every SFTConfig field is a flag (`--moment_dtype int8`, `--remat
dots_narrow`, ...).  The final train state goes to OUTPUT_DIR/final.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spacer_tpu_torch.cli.common import (
    ModelArgs,
    load_model_and_processor,
    setup_distributed,
    remat_arg,
)
from spacer_tpu_torch.utils.config import parse_configs


@dataclasses.dataclass
class ScriptArgs:
    dataset_name: str = "dataset.jsonl"
    max_rows: Optional[int] = None


def main(argv=None):
    from spacer_tpu_torch.data import load_jsonl_dataset
    from spacer_tpu_torch.train.sft_trainer import SFTConfig, SFTTrainer

    script, train_cfg, model_args = parse_configs(
        (ScriptArgs, SFTConfig, ModelArgs), argv)
    train_cfg.remat = remat_arg(train_cfg.remat)
    setup_distributed(model_args)
    cfg, params, processor, mesh = load_model_and_processor(model_args)

    rows = load_jsonl_dataset(script.dataset_name)
    if script.max_rows:
        rows = rows[:script.max_rows]

    trainer = SFTTrainer(cfg, params, processor, rows, train_cfg, mesh=mesh)
    trainer.train()
    trainer.save_checkpoint(train_cfg.output_dir + "/final")


if __name__ == "__main__":
    main()
