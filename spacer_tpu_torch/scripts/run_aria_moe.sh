#!/usr/bin/env bash
# Aria-MoE GRPO training on NPROC GPUs of one host (reference parity: the
# role of local_scripts/train_aria_moe.sh, plain-DP GRPO on rhymes-ai/Aria,
# max_prompt 8192, bs 1/device, 1 epoch): torchrun, one process per GPU,
# TP ranks of tensor parallelism (the fastest mesh axis) and fsdp = NPROC /
# TP.  MOE_IMPL picks the MoE (exported as SPACER_MOE_IMPL, which the Aria
# config reads): "ragged" shards the experts flat like any other tensor
# and gathers them per layer, "ep" places them by expert over fsdp and
# moves the routed tokens instead.  Counterpart of scripts/run_aria_moe.sh.
set -euo pipefail

NPROC="${NPROC:-8}"
TP="${TP:-1}"
export SPACER_MOE_IMPL="${MOE_IMPL:-ragged}"
export TOKENIZERS_PARALLELISM=false
export DEBUG_MODE="${DEBUG_MODE:-false}"
export LOG_PATH="${LOG_PATH:-./debug_log_aria.txt}"

torchrun --nproc_per_node "$NPROC" -m spacer_tpu_torch.cli.train_grpo \
    --multihost true \
    --tp "$TP" \
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
