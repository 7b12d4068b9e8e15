#!/usr/bin/env bash
# SFT on NPROC GPUs of one host (reference parity: run_SpaceR_SFT.sh):
# torchrun, one process per GPU, fsdp = NPROC / TP, tp = TP; every rank collates the
# same per_device_batch_size rows and runs its share of them, as the JAX
# trainer runs one batch over its mesh.  Counterpart of
# scripts/run_spacer_sft.sh.
set -euo pipefail

NPROC="${NPROC:-8}"
TP="${TP:-1}"     # tensor-parallel cards per model copy (divides NPROC)

torchrun --nproc_per_node "$NPROC" -m spacer_tpu_torch.cli.train_sft \
    --multihost true \
    --tp "$TP" \
    --output_dir "output/SpaceR-SFT" \
    --model_name_or_path "${MODEL:-checkpoints/Qwen2.5-VL-7B-Instruct}" \
    --dataset_name "${DATASET:-sft_data.jsonl}" \
    --learning_rate 1e-5 \
    --num_train_epochs 1 \
    --save_steps 1000 \
    "$@"
