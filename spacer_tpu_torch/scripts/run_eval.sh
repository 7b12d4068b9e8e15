#!/usr/bin/env bash
# Multi-benchmark evaluation (reference parity: SpaceR-Eval/evaluate.py
# __main__ constants): torchrun with NPROC processes (1 by default), the
# model split over tp = TP of them (NPROC by default); every rank runs the
# same rows, rank 0 writes.  Counterpart of scripts/run_eval.sh.
set -euo pipefail

NPROC="${NPROC:-1}"
TP="${TP:-$NPROC}"
TASK="${TASK:-VSI-Bench}"   # VSI-Bench STI-Bench SPAR-Bench Video-MME LongVideoBench TempCompass

torchrun --nproc_per_node "$NPROC" -m spacer_tpu_torch.cli.evaluate \
    --multihost true \
    --tp "$TP" \
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
