# Copied from spacer_tpu/evalharness/benchmarks/videomme.py; only its imports point at spacer_tpu_torch.
"""Video-MME worker + scorer (SpaceR-Eval/data_utils/videomme.py parity):
MCQ with options joined into the question (:106-109), answer-prefix
stripping + [ABCD] regex (:177-192), per-duration and per-task aggregation
(:194-215).
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
from spacer_tpu_torch.evalharness.benchmarks.stibench import QUESTION_TEMPLATE

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

_ANSWER_PREFIXES = [
    "The best answer is", "The correct answer is", "The answer is",
    "The answer", "The best option is", "The correct option is",
    "Best answer:", "Best option:", "Answer:", "Option:",
    "The correct answer", "The correct option",
]


def extract_characters_regex(s: str) -> str:
    s = s.strip()
    for prefix in _ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    m = re.search(r"[ABCD]", s)
    return m[0] if m else ""


def videomme_aggregate_results(results: list[dict]) -> dict:
    output = {}
    by_duration = defaultdict(list)
    for doc in results:
        by_duration[doc["duration"]].append(doc)
    for duration, docs in by_duration.items():
        dur_out = {}
        by_task = defaultdict(list)
        for doc in docs:
            by_task[doc["task"]].append(doc["accuracy"])
        for task, accs in by_task.items():
            dur_out[f"{task}_accuracy"] = float(np.mean(accs))
        dur_out["overall_accuracy"] = float(
            np.mean([d["accuracy"] for d in docs])
        )
        output[f"duration_{duration}"] = dur_out

    task_out = {}
    by_task = defaultdict(list)
    for doc in results:
        by_task[doc["task"]].append(doc["accuracy"])
    for task, accs in by_task.items():
        task_out[f"{task}_accuracy"] = float(np.mean(accs))
    task_out["overall_accuracy"] = float(
        np.mean([d["accuracy"] for d in results])
    )
    output["all_duration_tasks"] = task_out
    return output


def videomme_eval(jsonl_path: str, mode: str = "thinking") -> dict:
    results = []
    for doc in read_jsonl(jsonl_path):
        if mode == "thinking" and "<answer>" in doc["predicted_answer"]:
            doc["predicted_answer"] = extract_answer_text(doc["predicted_answer"])
        doc["predicted_answer"] = extract_characters_regex(doc["predicted_answer"])
        doc["accuracy"] = (
            1.0 if doc["predicted_answer"] == doc["ground_truth"] else 0.0
        )
        results.append(doc)
    return videomme_aggregate_results(results)


def evaluate_videomme(
    rank, world_size, data_file, video_dir, engine, output_dir, *,
    num_frames=32, fps=1, target_resolution=(448, 448), debug=False,
    batch_size=1, debug_size=4, prompt_type="thinking",
    max_new_tokens=None, serving="static", temperature=0.01,
):
    import pandas as pd

    rows = pd.read_parquet(data_file).to_dict("records")
    tpl = PROMPT_TEMPLATES.get(prompt_type, PROMPT_TEMPLATES["default"])

    def build_sample(row):
        video_path = os.path.join(video_dir, f"{row['videoID']}.mp4")
        if not os.path.exists(video_path):
            return None
        frames, timestamps, duration = load_video_frames(
            video_path, num_frames, fps, target_resolution
        )
        if frames is None:
            return None
        question = (
            row["question"] + "\nOptions:\n" + "\n".join(list(row["options"]))
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
            "id": row["question_id"],
            "question": row["question"],
            "ground_truth": row["answer"],
            "task": row["task_type"],
            "promt": prompt_text,
            "duration": row["duration"],
        }
        return messages, record

    max_new = max_new_tokens if max_new_tokens is not None else (
        128 if prompt_type == "default" else 1024)
    return run_worker(
        task="Video-MME", rank=rank, world_size=world_size, rows=rows,
        build_sample=build_sample, engine=engine, output_dir=output_dir,
        batch_size=batch_size, serving=serving, max_new_tokens=max_new,
        temperature=temperature,
        debug=debug, debug_size=debug_size,
    )
