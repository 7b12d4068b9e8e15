# Copied from spacer_tpu/utils/logging.py (stdlib only; no JAX).
"""Metric/event logging and DEBUG_MODE rollout tracing.

Formalizes the reference's validation mechanisms (SURVEY.md section 4):
- jsonl metric stream (wandb-compatible records, no network dependency)
- DEBUG_MODE=true + LOG_PATH appends completion/solution/reward traces
  (SG-RLVR.py:227-234 semantics live in rewards.accuracy; this module adds a
  structured variant for the trainer)
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from datetime import datetime


def setup_logger(name: str, log_dir: str | None = None,
                 rank: int | None = None) -> logging.Logger:
    """Per-rank file+stderr logger (SpaceR-Eval/util.py:30-43 parity)."""
    logger = logging.getLogger(name if rank is None else f"{name}.r{rank}")
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        suffix = f"_rank{rank}" if rank is not None else ""
        fh = logging.FileHandler(
            os.path.join(log_dir, f"{name}{suffix}_{stamp}.log")
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Append-only jsonl metric/event sink under output_dir.

    When wandb is importable and WANDB_MODE/WANDB_PROJECT is configured
    (`--report_to wandb` equivalent, run_SpaceR_SFT.sh:22), records are
    mirrored there; the jsonl stream is always written.
    """

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.metrics_path = os.path.join(output_dir, "metrics.jsonl")
        self.events_path = os.path.join(output_dir, "events.jsonl")
        self._wandb = None
        if os.environ.get("WANDB_PROJECT") or os.environ.get("WANDB_MODE"):
            try:
                import wandb

                if wandb.run is None:
                    wandb.init(
                        project=os.environ.get("WANDB_PROJECT", "spacer-tpu"),
                        dir=output_dir,
                    )
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log_metrics(self, record: dict):
        record = dict(record, _ts=time.time())
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log(
                    {k: v for k, v in record.items() if k != "_ts"},
                    step=int(record.get("step", 0)),
                )
            except Exception:
                pass

    def log_event(self, record: dict):
        record = dict(record, _ts=time.time())
        with open(self.events_path, "a") as f:
            f.write(json.dumps(record) + "\n")


def debug_trace(kind: str, **fields):
    """DEBUG_MODE rollout tracing: appends to $LOG_PATH when enabled."""
    if os.getenv("DEBUG_MODE") != "true":
        return
    log_path = os.getenv("LOG_PATH")
    if not log_path:
        return
    stamp = datetime.now().strftime("%d-%H-%M-%S-%f")
    with open(log_path, "a", encoding="utf-8") as f:
        f.write(f"------------- {stamp} {kind} -------------\n")
        for k, v in fields.items():
            f.write(f"{k}: {v}\n")


class NullLogger:
    """The MetricLogger of a rank that writes nothing (every rank of a
    multi-process run but rank 0)."""

    def log_metrics(self, record: dict):
        pass

    def log_event(self, record: dict):
        pass


def rank_logger(output_dir: str):
    """MetricLogger on rank 0 (or without a process group), else a
    NullLogger."""
    from spacer_tpu_torch.parallel.multihost import process_index

    return MetricLogger(output_dir) if process_index() == 0 else NullLogger()
