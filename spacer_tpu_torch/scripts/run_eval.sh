#!/usr/bin/env bash
# Multi-benchmark evaluation on one GPU (reference parity:
# SpaceR-Eval/evaluate.py __main__ constants): torchrun with one process;
# evaluation over more processes needs tensor parallelism, which is not
# ported.  Counterpart of scripts/run_eval.sh.
set -euo pipefail

TASK="${TASK:-VSI-Bench}"   # VSI-Bench STI-Bench SPAR-Bench Video-MME LongVideoBench TempCompass

torchrun --nproc_per_node 1 -m spacer_tpu_torch.cli.evaluate \
    --multihost true \
    --task "$TASK" \
    --model_name_or_path "${MODEL:-checkpoints/SpaceR}" \
    --data_root "${DATA_ROOT:-.}" \
    --output_dir "eval_output/${TASK}" \
    --num_frames 32 \
    --fps 1 \
    --target_resolution 448,448 \
    --prompt_type thinking \
    --batch_size 1 \
    "$@"
