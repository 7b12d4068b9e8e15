# Copied from spacer_tpu/evalharness/benchmarks/stibench.py; only its imports point at spacer_tpu_torch.
"""STI-Bench worker + scorer (SpaceR-Eval/data_utils/stibench.py parity):
time-windowed questions with candidate options (:96-101), 6-pattern letter
normalization (:180-198), per-task means + SR sub-task average (:199-241).
"""

from __future__ import annotations

import os
import re
from collections import defaultdict

import numpy as np

from spacer_tpu_torch.evalharness.benchmarks.common import run_worker
from spacer_tpu_torch.evalharness.util import (
    extract_answer_text,
    load_video_frames,
    read_jsonl,
)

QUESTION_TEMPLATE = (
    "Question: {Question}\n"
    "Please think about this question as if you were a human pondering deeply. "
    "Engage in an internal dialogue using expressions such as 'let me think', "
    "'wait', 'Hmm', 'oh, I see', 'let's break it down', etc, or other natural "
    "language thought expressions "
    "It's encouraged to include self-reflection or verification in the "
    "reasoning process. "
    "Provide your detailed reasoning between the <think> </think> tags, and "
    "then give your final answer between the <answer> </answer> tags."
)

PROMPT_TEMPLATES = {
    "default": {
        "pre_prompt": "Question: {Question}\n",
        "mca_post_prompt": (
            "Answer with the option's letter from the given choices directly."
        ),
    },
    "thinking": {
        "pre_prompt": QUESTION_TEMPLATE,
        "mca_post_prompt": (
            "Please provide only the single option letter (e.g., A, B, C, D, "
            "etc.) within the <answer> </answer> tags."
        ),
    },
}

SR_SUB_TASKS = [
    "Dimensional Measurement", "Displacement & Path Length",
    "Ego-Centric Orientation", "Spatial Relation", "Speed & Acceleration",
    "Trajectory Description",
]

_PATTERNS = [
    r"\(([A-E])\)",
    r"Ans\s*=\s*['\"]?([A-E])['\"]?",
    r"Answer\s*[:=]\s*([A-E])",
    r"Option\s+([A-E])",
    r"\b([A-E])\s*(?:is|was)\s*correct",
    r"\b([A-E])[\.\)]\s*$",
]


def normalize_answer(text: str):
    """Extract a capital-letter answer; None when no pattern matches."""
    for pattern in _PATTERNS:
        m = re.search(pattern, text, flags=re.IGNORECASE | re.MULTILINE)
        if m:
            return m.group(1).upper()
    return None


def stibench_aggregate_results(results: list[dict]) -> dict:
    by_task = defaultdict(list)
    for doc in results:
        by_task[doc["task"]].append(doc["accuracy"])
    output = {task: float(np.mean(v)) for task, v in by_task.items()}
    sr = [output[t] for t in SR_SUB_TASKS if t in output]
    output["sr_sub_accuracy"] = sum(sr) / len(sr) if sr else 0.0
    output["overall_accuracy"] = (
        sum(output.values()) / len(output) if output else 0.0
    )
    return output


def stibench_eval(jsonl_path: str, mode: str = "thinking") -> dict:
    results = []
    for doc in read_jsonl(jsonl_path):
        if mode == "thinking" and "<answer>" in doc["predicted_answer"]:
            doc["predicted_answer"] = extract_answer_text(doc["predicted_answer"])
        doc["predicted_answer"] = (
            normalize_answer(doc["predicted_answer"])
            or doc["predicted_answer"].strip()
        )
        doc["accuracy"] = (
            1.0 if doc["predicted_answer"] == doc["ground_truth"] else 0.0
        )
        results.append(doc)
    return stibench_aggregate_results(results)


def evaluate_stibench(
    rank, world_size, data_file, video_dir, engine, output_dir, *,
    num_frames=32, fps=1, target_resolution=(448, 448), debug=False,
    batch_size=1, debug_size=4, prompt_type="thinking",
    max_new_tokens=None, serving="static", temperature=0.01,
):
    import pandas as pd

    rows = pd.read_parquet(data_file).to_dict("records")
    tpl = PROMPT_TEMPLATES.get(prompt_type, PROMPT_TEMPLATES["default"])

    def build_sample(row):
        video_path = os.path.join(video_dir, row["Video"])
        if not os.path.exists(video_path):
            return None
        frames, timestamps, duration = load_video_frames(
            video_path, num_frames, fps, target_resolution
        )
        if frames is None:
            return None
        candidate_list = [f"{k} {v}" for k, v in row["Candidates"].items()]
        question = (
            f"From {row['time_start']} seconds to {row['time_end']} seconds. "
            + row["Question"] + "\n" + "\n".join(candidate_list)
        )
        prompt_text = tpl["pre_prompt"].format(Question=question)
        prompt_text += "\n" + tpl["mca_post_prompt"]
        messages = [{
            "role": "user",
            "content": [
                {"type": "video", "video": frames},
                {"type": "text", "text": prompt_text},
            ],
        }]
        record = {
            "id": row["ID"],
            "question": row["Question"],
            "ground_truth": row["Answer"],
            "task": row["Task"],
            "promt": prompt_text,
            "frame_timestamps": timestamps,
            "video_duration": duration,
        }
        return messages, record

    max_new = max_new_tokens if max_new_tokens is not None else (
        128 if prompt_type == "default" else 1024)
    return run_worker(
        task="STI-Bench", rank=rank, world_size=world_size, rows=rows,
        build_sample=build_sample, engine=engine, output_dir=output_dir,
        batch_size=batch_size, serving=serving, max_new_tokens=max_new,
        temperature=temperature,
        debug=debug, debug_size=debug_size,
    )
