#!/usr/bin/env bash
# Aria-MoE GRPO training on NPROC GPUs of one host (reference parity: the
# role of local_scripts/train_aria_moe.sh, plain-DP GRPO on rhymes-ai/Aria,
# max_prompt 8192, bs 1/device, 1 epoch): torchrun, one process per GPU,
# fsdp = NPROC (the experts shard flat like any other tensor; expert
# parallelism is not ported).  Counterpart of scripts/run_aria_moe.sh.
set -euo pipefail

NPROC="${NPROC:-8}"
export TOKENIZERS_PARALLELISM=false
export DEBUG_MODE="${DEBUG_MODE:-false}"
export LOG_PATH="${LOG_PATH:-./debug_log_aria.txt}"

torchrun --nproc_per_node "$NPROC" -m spacer_tpu_torch.cli.train_grpo \
    --multihost true \
    --rollout_batch_size "$NPROC" \
    --output_dir "output/Aria-GRPO-mini_cot_80k" \
    --model_name_or_path "${MODEL:-checkpoints/Aria}" \
    --model_family aria \
    --dataset_name "${DATASET:-mini_cot_80k.jsonl}" \
    --max_prompt_length 8192 \
    --gradient_accumulation_steps 1 \
    --logging_steps 1 \
    --num_train_epochs 1 \
    --save_steps 1000 \
    "$@"
