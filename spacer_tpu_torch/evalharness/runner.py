"""Eval orchestrator (SpaceR-Eval/evaluate.py equivalent with a real config
system instead of __main__ literals; counterpart of
spacer_tpu/evalharness/runner.py, which it copies but for the refusal of
speculative decoding, not ported)."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

from spacer_tpu_torch.evalharness.util import format_time, merge_results
from spacer_tpu_torch.utils.logging import setup_logger

SUPPORTED_TASKS = [
    "VSI-Bench", "STI-Bench", "SPAR-Bench", "Video-MME", "LongVideoBench",
    "TempCompass",
]


@dataclasses.dataclass
class EvalConfig:
    """Replaces the constants block at evaluate.py:88-118."""

    task: str = "VSI-Bench"
    data_root: str = "."
    output_dir: str = "eval_output"
    model_name: str = ""
    num_frames: int = 32
    fps: float = 1.0
    target_resolution: tuple[int, int] = (448, 448)
    prompt_type: str = "thinking"
    batch_size: int = 1
    world_size: int = 1
    rank: Optional[int] = None     # None: run all ranks in-process
    debug: bool = False
    debug_size: int = 4
    data_file: Optional[str] = None
    video_dir: Optional[str] = None
    mode: Optional[str] = None     # scorer mode; defaults to prompt_type
    # override the prompt_type-derived decode budget (1024 thinking / 128
    # default, vsibench.py:170-174); None keeps reference behavior
    max_new_tokens: Optional[int] = None
    # "static": batch_size prompts per decode program (all rows run until
    # the longest finishes); "continuous": stream prompts through
    # batch_size decode slots with mid-flight refill (serving/batcher.py,
    # the vLLM-role path — requires the engine to expose generate_many)
    serving: str = "static"
    # decode temperature (reference: 0.01 for every benchmark,
    # evaluate.py:106-118).  0.0 = exact greedy
    temperature: float = 0.01
    # prompt-lookup speculative decoding in the JAX package; kept so its
    # configs parse, and refused by run_benchmark when nonzero (not ported)
    speculate_k: int = 0


def prepare_data(task: str, data_root: str = ".") -> tuple:
    """Default dataset locations under data_root (evaluate.py:43-68)."""
    paths = {
        "VSI-Bench": ("VSI_bench/test-00000-of-00001.parquet", "VSI_bench"),
        "STI-Bench": ("STI-Bench/qa.parquet", "STI-Bench/video"),
        "SPAR-Bench": (
            [f"SPAR-Bench/data/test-0000{i}-of-00004.parquet" for i in range(4)],
            "SPAR-7M/spar/structured3d/images",
        ),
        "Video-MME": (
            "Video-MME/videomme/test-00000-of-00001.parquet", "Video-MME/data"
        ),
        "LongVideoBench": ("LongVideoBench/lvb_val.json", "LongVideoBench/videos"),
        "TempCompass": ("TempCompass/eval_tempcompass.json", "TempCompass/videos"),
    }
    if task not in paths:
        raise ValueError(f"Task {task} not recognized for data preparation.")
    data_file, video_dir = paths[task]
    if isinstance(data_file, list):
        data_file = [os.path.join(data_root, p) for p in data_file]
    else:
        data_file = os.path.join(data_root, data_file)
    return data_file, os.path.join(data_root, video_dir)


def _worker_fn(task: str):
    from spacer_tpu_torch.evalharness.benchmarks import (
        longvideobench, sparbench, stibench, tempcompass, videomme, vsibench,
    )

    return {
        "VSI-Bench": vsibench.evaluate_vsibench,
        "STI-Bench": stibench.evaluate_stibench,
        "SPAR-Bench": sparbench.evaluate_sparbench,
        "Video-MME": videomme.evaluate_videomme,
        "LongVideoBench": longvideobench.evaluate_longvideobench,
        "TempCompass": tempcompass.evaluate_tempcompass,
    }[task]


def _scorer_fn(task: str):
    from spacer_tpu_torch.evalharness.benchmarks import (
        longvideobench, sparbench, stibench, tempcompass, videomme, vsibench,
    )

    return {
        "VSI-Bench": vsibench.vsibench_eval,
        "STI-Bench": stibench.stibench_eval,
        "SPAR-Bench": sparbench.sparbench_eval,
        "Video-MME": videomme.videomme_eval,
        "LongVideoBench": longvideobench.longvideobench_eval,
        "TempCompass": tempcompass.tempcompass_eval,
    }[task]


def check_unported(cfg: EvalConfig) -> None:
    if cfg.speculate_k:
        raise NotImplementedError(
            f"speculate_k={cfg.speculate_k}: speculative decoding is not "
            "ported (ROADMAP queue A item 3); pass --speculate_k 0")


def run_benchmark(cfg: EvalConfig, engine) -> dict:
    """Run worker shards + merge + score. Returns the metrics dict.

    With cfg.rank=None all shards run sequentially in this process (single
    TPU host drives all data); in multi-host SPMD each host passes its own
    rank and only rank 0 merges/scores.
    """
    check_unported(cfg)
    logger = setup_logger(f"eval.{cfg.task}", cfg.output_dir)
    if cfg.task not in SUPPORTED_TASKS:
        raise ValueError(f"unsupported task {cfg.task}")
    data_file = cfg.data_file
    video_dir = cfg.video_dir
    if data_file is None or video_dir is None:
        d, v = prepare_data(cfg.task, cfg.data_root)
        data_file = data_file or d
        video_dir = video_dir or v

    worker = _worker_fn(cfg.task)
    os.makedirs(cfg.output_dir, exist_ok=True)
    t0 = time.time()
    ranks = range(cfg.world_size) if cfg.rank is None else [cfg.rank]
    elapsed = []
    for rank in ranks:
        _, dt = worker(
            rank, cfg.world_size, data_file, video_dir, engine,
            cfg.output_dir, num_frames=cfg.num_frames, fps=cfg.fps,
            target_resolution=tuple(cfg.target_resolution), debug=cfg.debug,
            batch_size=cfg.batch_size, debug_size=cfg.debug_size,
            prompt_type=cfg.prompt_type, max_new_tokens=cfg.max_new_tokens,
            serving=cfg.serving, temperature=cfg.temperature,
        )
        elapsed.append(dt)
    logger.info(
        f"{cfg.task}: {len(elapsed)} shard(s), max shard time "
        f"{format_time(max(elapsed))}"
    )
    if cfg.rank not in (None, 0):
        return {}

    merged = os.path.join(cfg.output_dir, f"{cfg.task}_results.jsonl")
    merge_results(cfg.world_size, merged, cfg.task)
    metrics = score_results(cfg.task, merged, mode=cfg.mode or cfg.prompt_type)
    logger.info(f"{cfg.task} results: {metrics}")
    logger.info(f"total wall time {format_time(time.time() - t0)}")
    return metrics


def score_results(task: str, jsonl_path: str, mode: str = "thinking") -> dict:
    return _scorer_fn(task)(jsonl_path, mode)
