#!/usr/bin/env bash
# Plain video-GRPO on NPROC GPUs of one host (reference parity:
# run_grpo_video.sh): torchrun, one process per GPU, fsdp = NPROC / TP, tp = TP, one
# prompt per rank and step.  Counterpart of scripts/run_grpo_video.sh.
set -euo pipefail

NPROC="${NPROC:-8}"
TP="${TP:-1}"     # tensor-parallel cards per model copy (divides NPROC)
export DEBUG_MODE="${DEBUG_MODE:-false}"
export LOG_PATH="${LOG_PATH:-./debug_log_grpo.txt}"

torchrun --nproc_per_node "$NPROC" -m spacer_tpu_torch.cli.train_grpo \
    --multihost true \
    --tp "$TP" \
    --rollout_batch_size "$NPROC" \
    --output_dir "output/GRPO-Video" \
    --model_name_or_path "${MODEL:-checkpoints/Qwen2.5-VL-7B-Instruct}" \
    --dataset_name "${DATASET:-video_data.jsonl}" \
    --max_prompt_length 16384 \
    --max_completion_length 1024 \
    --learning_rate 1e-6 \
    --temporal true \
    --len_control true \
    --num_generations 8 \
    "$@"
