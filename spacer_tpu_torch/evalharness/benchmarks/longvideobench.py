# Copied from spacer_tpu/evalharness/benchmarks/longvideobench.py; only its imports point at spacer_tpu_torch.
"""LongVideoBench worker + scorer (SpaceR-Eval/data_utils/longvideobench.py
parity): options lettered from candidates (:101-106), GT letter from
correct_choice (:158), [ABCDE] extraction (:185-205), per-category plus
perception/relation aggregation (:207-233).
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

PERCEPTION_TASK = ["S2E", "S2O", "S2A", "E2O", "O2E", "T2E", "T2O", "T2A"]
RELATION_TASK = ["E3E", "O3O", "SSS", "SOS", "SAA", "T3E", "T3O", "TOS", "TAA"]

_ANSWER_PREFIXES = [
    "The best answer is", "The correct answer is", "The answer is",
    "The answer", "The best option is", "The correct option is",
    "Best answer:", "Best option:", "Answer:", "Option:",
]


def extract_characters_regex(s: str) -> str:
    s = s.strip()
    for prefix in _ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCDE]", s):
        return ""
    m = re.search(r"[ABCDE]", s)
    return m[0] if m else ""


def longvideobench_aggregate_results(results: list[dict]) -> dict:
    output = {
        "overall_accuracy": float(np.mean([d["accuracy"] for d in results]))
    }
    by_task = defaultdict(list)
    for doc in results:
        by_task[doc["question_category"]].append(doc["accuracy"])
    output["all_duration_tasks"] = {
        f"{task}_accuracy": float(np.mean(v)) for task, v in by_task.items()
    }
    perception = [
        d["accuracy"] for d in results
        if d["question_category"] in PERCEPTION_TASK
    ]
    relation = [
        d["accuracy"] for d in results
        if d["question_category"] in RELATION_TASK
    ]
    output["perception_task_accuracy"] = (
        float(np.mean(perception)) if perception else float("nan")
    )
    output["relation_task_accuracy"] = (
        float(np.mean(relation)) if relation else float("nan")
    )
    return output


def longvideobench_eval(jsonl_path: str, mode: str = "thinking") -> dict:
    results = []
    for doc in read_jsonl(jsonl_path):
        if mode == "thinking" and "<answer>" in doc["predicted_answer"]:
            doc["predicted_answer"] = extract_answer_text(doc["predicted_answer"])
        doc["predicted_answer"] = extract_characters_regex(doc["predicted_answer"])
        doc["accuracy"] = (
            1.0 if doc["predicted_answer"] == doc["ground_truth"] else 0.0
        )
        results.append(doc)
    return longvideobench_aggregate_results(results)


def evaluate_longvideobench(
    rank, world_size, data_file, video_dir, engine, output_dir, *,
    num_frames=32, fps=1, target_resolution=(448, 448), debug=False,
    batch_size=1, debug_size=4, prompt_type="thinking",
    max_new_tokens=None, serving="static", temperature=0.01,
):
    import json

    with open(data_file) as f:
        rows = json.load(f)
    tpl = PROMPT_TEMPLATES.get(prompt_type, PROMPT_TEMPLATES["default"])

    def build_sample(row):
        video_path = os.path.join(video_dir, f"{row['video_id']}.mp4")
        if not os.path.exists(video_path):
            return None
        frames, timestamps, duration = load_video_frames(
            video_path, num_frames, fps, target_resolution
        )
        if frames is None:
            return None
        question = row["question"] + "\nOptions:\n"
        options = ""
        for i, candidate in enumerate(row["candidates"]):
            options += f"{chr(ord('A') + i)}. {candidate}\n"
        question += options
        prompt_text = tpl["pre_prompt"].format(Question=question)
        prompt_text += tpl["mca_post_prompt"]
        messages = [{
            "role": "user",
            "content": [
                {"type": "video", "video": frames},
                {"type": "text", "text": prompt_text},
            ],
        }]
        record = {
            "id": row["id"],
            "question": row["question"],
            "ground_truth": chr(ord("A") + int(row["correct_choice"])),
            "question_category": row["question_category"],
            "topic_category": row["topic_category"],
            "promt": prompt_text,
            "duration": row["duration"],
        }
        return messages, record

    max_new = max_new_tokens if max_new_tokens is not None else (
        128 if prompt_type == "default" else 1024)
    return run_worker(
        task="LongVideoBench", rank=rank, world_size=world_size, rows=rows,
        build_sample=build_sample, engine=engine, output_dir=output_dir,
        batch_size=batch_size, serving=serving, max_new_tokens=max_new,
        temperature=temperature,
        debug=debug, debug_size=debug_size,
    )
