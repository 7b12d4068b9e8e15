# Copied from spacer_tpu/evalharness/benchmarks/tempcompass.py; only its imports point at spacer_tpu_torch.
"""TempCompass worker + scorer (SpaceR-Eval/data_utils/tempcompass.py
parity): system-message prompt, per-problem-type templates (:20-40),
multi-format MC matcher eval_mc (:233-244).
"""

from __future__ import annotations

import os

import numpy as np

from spacer_tpu_torch.evalharness.benchmarks.common import run_worker
from spacer_tpu_torch.evalharness.util import (
    extract_answer_text,
    load_video_frames,
    read_jsonl,
)

SYSTEM_MESSAGE = "You are a helpful assistant"

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

TYPE_TEMPLATE = {
    "default": {
        "pre-prompt": "Question: {Question}\n",
        "multiple choice": (
            " Please provide only the single option letter "
            "(e.g., A, B, C, D, etc.)."
        ),
        "numerical": " Please provide the numerical value (e.g., 42 or 3.14).",
        "OCR": (
            " Please transcribe text from the image/video clearly and "
            "provide your text answer."
        ),
        "free-form": " Please provide your text answer.",
        "regression": " Please provide the numerical value (e.g., 42 or 3.14).",
    },
    "thinking": {
        "pre-prompt": QUESTION_TEMPLATE,
        "multiple choice": (
            " Please provide only the single option letter (e.g., A, B, C, "
            "D, etc.) within the <answer> </answer> tags."
        ),
        "numerical": (
            " Please provide the numerical value (e.g., 42 or 3.14) within "
            "the <answer> </answer> tags."
        ),
        "OCR": (
            " Please transcribe text from the image/video clearly and "
            "provide your text answer within the <answer> </answer> tags."
        ),
        "free-form": (
            " Please provide your text answer within the <answer> </answer> "
            "tags."
        ),
        "regression": (
            " Please provide the numerical value (e.g., 42 or 3.14) within "
            "the <answer> </answer> tags."
        ),
    },
}


def eval_mc(pred: str, ans: str) -> int:
    """Multi-format MC matcher (tempcompass.py:233-244)."""
    if pred == ans:
        return 1
    if pred in ["A", "B", "C", "D"]:
        return 1 if pred == ans[0] else 0
    if any(pred.startswith(p) for p in ["A.", "B.", "C.", "D."]):
        return 1 if pred.split(".")[0] == ans[0] else 0
    if any(pred.startswith(p) for p in ["A)", "B)", "C)", "D)"]):
        return 1 if pred.split(")")[0] == ans[0] else 0
    return 0


def tempcompass_aggregate_results(results: list[dict]) -> dict:
    return {
        "overall_accuracy": float(np.mean([d["accuracy"] for d in results]))
    }


def tempcompass_eval(jsonl_path: str, mode: str = "thinking") -> dict:
    results = []
    for doc in read_jsonl(jsonl_path):
        doc["answer"] = extract_answer_text(doc["answer"])
        if mode == "thinking" and "<answer>" in doc["prediction"]:
            doc["prediction"] = extract_answer_text(doc["prediction"])
        doc["accuracy"] = eval_mc(doc["prediction"], doc["answer"])
        results.append(doc)
    return tempcompass_aggregate_results(results)


def evaluate_tempcompass(
    rank, world_size, data_file, video_dir, engine, output_dir, *,
    num_frames=32, fps=1, target_resolution=(448, 448), debug=False,
    batch_size=1, debug_size=4, prompt_type="thinking",
    max_new_tokens=None, serving="static", temperature=0.01,
):
    import pandas as pd

    rows = pd.read_json(data_file).to_dict("records")
    tpl = TYPE_TEMPLATE.get(prompt_type, TYPE_TEMPLATE["default"])

    def build_sample(row):
        video_path = os.path.join(video_dir, f"{row['video_id']}.mp4")
        if not os.path.exists(video_path):
            return None
        frames, timestamps, duration = load_video_frames(
            video_path, num_frames, fps, target_resolution
        )
        if frames is None:
            return None
        if row["problem_type"] == "multiple choice":
            question = row["problem"] + "Options:\n"
            for op in row["options"]:
                question += op + "\n"
        else:
            question = row["problem"]
        prompt_text = (
            tpl["pre-prompt"].format(Question=question)
            + tpl[row["problem_type"]]
        )
        messages = [
            {
                "role": "system",
                "content": [{"type": "text", "text": SYSTEM_MESSAGE}],
            },
            {
                "role": "user",
                "content": [
                    {"type": "video", "video": frames},
                    {"type": "text", "text": prompt_text},
                ],
            },
        ]
        record = {
            "question": question,
            "answer": row["solution"],
            "promt": prompt_text,
        }
        return messages, record

    max_new = max_new_tokens if max_new_tokens is not None else (
        128 if prompt_type == "default" else 1024)
    out_path, elapsed = run_worker(
        task="TempCompass", rank=rank, world_size=world_size, rows=rows,
        build_sample=build_sample, engine=engine, output_dir=output_dir,
        batch_size=batch_size, serving=serving, max_new_tokens=max_new,
        temperature=temperature,
        debug=debug, debug_size=debug_size,
    )
    # reference stores the model output under 'prediction' for this task
    from spacer_tpu_torch.evalharness.util import read_jsonl as _read, write_jsonl

    records = _read(out_path)
    for r in records:
        r["prediction"] = r.pop("predicted_answer", "")
    write_jsonl(out_path, records)
    return out_path, elapsed
