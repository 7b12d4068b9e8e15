#!/usr/bin/env bash
# SG-RLVR training on NPROC GPUs of one host (reference parity:
# run_SpaceR_SG_RLVR.sh): one process per GPU under torchrun, params,
# gradients and optimizer state sharded over fsdp = NPROC / TP and split
# over tp = TP (Qwen only; TP=1 by default), NPROC prompts per step
# (rollout_batch_size is the global prompt count, the reference's 8
# processes x 1).  Counterpart of scripts/run_spacer_sg_rlvr.sh.
set -euo pipefail

NPROC="${NPROC:-8}"
TP="${TP:-1}"     # tensor-parallel cards per model copy (divides NPROC)
export DEBUG_MODE="${DEBUG_MODE:-false}"   # rollout tracing (rewards append to LOG_PATH)
export LOG_PATH="${LOG_PATH:-./debug_log_SpaceR.txt}"

torchrun --nproc_per_node "$NPROC" -m spacer_tpu_torch.cli.train_sg_rlvr \
    --multihost true \
    --tp "$TP" \
    --rollout_batch_size "$NPROC" \
    --output_dir "output/SpaceR-SG-RLVR" \
    --model_name_or_path "${MODEL:-checkpoints/Qwen2.5-VL-7B-Instruct}" \
    --dataset_name "SpaceR-151k.jsonl" \
    --cognitive_map_path "annotation/cognitive_map.jsonl" \
    --max_prompt_length 16384 \
    --max_completion_length 1024 \
    --learning_rate 1e-6 \
    --weight_decay 0.01 \
    --logging_steps 1 \
    --temporal true \
    --len_control true \
    --max_pixels 401408 \
    --num_train_epochs 1 \
    --save_steps 1000 \
    --beta 0.04 \
    --max_grad_norm 5 \
    --num_generations 8 \
    "$@"
