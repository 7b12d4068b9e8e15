# Copied from spacer_tpu/evalharness/benchmarks/common.py; only its imports point at spacer_tpu_torch.
"""Shared worker scaffolding and scoring primitives."""

from __future__ import annotations

import os
import time
from typing import Callable, Sequence

import numpy as np

from spacer_tpu_torch.evalharness.util import write_jsonl
from spacer_tpu_torch.utils.logging import setup_logger


def shard_rows(rows: Sequence, rank: int, world_size: int):
    """np.array_split contiguous sharding (vsibench.py:73-77)."""
    if world_size <= 1:
        return list(rows)
    idx = np.array_split(np.arange(len(rows)), world_size)[rank]
    return [rows[int(i)] for i in idx]


def run_worker(
    *,
    task: str,
    rank: int,
    world_size: int,
    rows: Sequence[dict],
    build_sample: Callable[[dict], tuple | None],
    engine,
    output_dir: str,
    batch_size: int = 1,
    max_new_tokens: int = 128,
    temperature: float = 0.01,
    debug: bool = False,
    debug_size: int = 4,
    seed: int = 0,
    serving: str = "static",
) -> tuple[str, float]:
    """Generic eval worker: shard -> build -> generate -> per-rank jsonl.

    build_sample(row) returns (messages, result_record) or None to skip;
    the worker fills result_record['predicted_answer'].  Batch inference
    failures degrade to "" answers (vsibench.py:181-183 semantics).

    serving="continuous": prompts stream through the engine's
    continuous-batching path (engine.generate_many, serving/batcher.py)
    with batch_size decode slots, in waves of 8*batch_size requests so a
    shard's frames never all sit in host memory at once.  Finished slots
    refill mid-wave instead of idling until the longest answer in a static
    batch completes.
    """
    logger = setup_logger(f"eval.{task}", output_dir, rank)
    t0 = time.time()
    os.makedirs(output_dir, exist_ok=True)

    rows = list(rows)
    if debug:
        order = np.random.default_rng(seed).permutation(len(rows))[:debug_size]
        rows = [rows[int(i)] for i in order]
    shard = shard_rows(rows, rank, world_size)
    logger.info(f"rank {rank}/{world_size} shard={len(shard)}")

    continuous = serving == "continuous" and hasattr(engine, "generate_many")
    wave = batch_size * 8 if continuous else batch_size

    results = []
    for start in range(0, len(shard), wave):
        batch = shard[start : start + wave]
        built = [build_sample(r) for r in batch]
        built = [b for b in built if b is not None]
        if not built:
            continue
        messages = [b[0] for b in built]
        try:
            if continuous:
                answers = engine.generate_many(
                    messages, max_new_tokens=max_new_tokens,
                    temperature=temperature, slots=batch_size,
                )
            else:
                answers = engine.generate(
                    messages, max_new_tokens=max_new_tokens,
                    temperature=temperature,
                )
        except Exception as e:
            logger.error(f"rank {rank} batch inference failure: {e}")
            answers = [""] * len(built)
        for (_, record), ans in zip(built, answers):
            record["predicted_answer"] = ans
            results.append(record)

    out_path = os.path.join(output_dir, f"{task}_results_rank_{rank}.jsonl")
    write_jsonl(out_path, results)
    elapsed = time.time() - t0
    logger.info(f"rank {rank} wrote {out_path} ({len(results)} rows, "
                f"{elapsed:.1f}s)")
    return out_path, elapsed


def exact_match(pred: str, target: str) -> float:
    return 1.0 if pred.lower() == target.lower() else 0.0


def to_float(pred):
    try:
        return float(pred)
    except BaseException:
        return None


def mean_relative_accuracy(pred, target, start=0.5, end=0.95, interval=0.05,
                           zero_safe: bool = False):
    """MRA over linspace(start, end, int((end-start)/interval + 2)) — note
    the int() truncates the float-noisy 10.999... to 10 points for the
    default range, matching the reference exactly.

    zero_safe is the spar_util.py:225-230 variant: |pred-target| when
    target == 0, else |(pred-target)/target|.  The VSI/training variant
    (vsi_util.py:65-66) divides |pred-target| by the SIGNED target, so a
    negative target makes every threshold pass — reproduced deliberately.
    """
    num_pts = (end - start) / interval + 2
    conf = np.linspace(start, end, int(num_pts))
    if zero_safe:
        rel = abs(pred - target) if target == 0.0 else abs((pred - target) / target)
    else:
        rel = abs(pred - target) / target
    return float((rel <= 1 - conf).mean())
