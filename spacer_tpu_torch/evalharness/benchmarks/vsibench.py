# Copied from spacer_tpu/evalharness/benchmarks/vsibench.py; only its imports point at spacer_tpu_torch.
"""VSI-Bench worker + scorer.

Behavioral reference: SpaceR-Eval/data_utils/vsibench.py and vsi_util.py —
question types (:7-20), cognitive-map "thinking" prompt with the 23-class
OBJECT_LIST (:34-62), MCQ fuzzy letter matching (:120-126), numeric fuzzy
matching (:80-103), MRA scoring (:68-72), per-type aggregation with the
3-way rel-direction average (vsibench.py:14-42).
"""

from __future__ import annotations

import os
import re
from collections import defaultdict

import numpy as np

from spacer_tpu_torch.evalharness.benchmarks.common import (
    exact_match,
    mean_relative_accuracy,
    run_worker,
    to_float,
)
from spacer_tpu_torch.evalharness.util import (
    extract_answer_text,
    load_video_frames,
    read_jsonl,
)

MCA_QUESTION_TYPES = [
    "object_rel_direction_easy",
    "object_rel_direction_medium",
    "object_rel_direction_hard",
    "object_rel_distance",
    "route_planning",
    "obj_appearance_order",
]
NA_QUESTION_TYPES = [
    "object_abs_distance",
    "object_counting",
    "object_size_estimation",
    "room_size_estimation",
]

EXAMPLE_MAP = {"table": [[0, 3], [5, 7]], "chair": [[9, 3]], "window": [[6, 5]]}

OBJECT_LIST = [
    "ceiling light", "trash can", "bed", "heater", "closet", "pillow",
    "backpack", "chair", "refrigerator", "tv", "nightstand", "keyboard",
    "computer tower", "coat hanger", "table", "trash bin", "whiteboard",
    "monitor", "sofa", "clock", "computer mouse", "radiator", "telephone",
]

from spacer_tpu_torch.data.templates import COGMAP_TEMPLATE  # same text (vsi_util.py:35-45)

PROMPT_TEMPLATES = {
    "default": {
        "pre_prompt": "Question: {Question}\n",
        "mca_post_prompt": (
            "Answer with the option's letter from the given choices directly."
        ),
        "na_post_prompt": (
            "Please answer the question using a numerical value "
            "(e.g., 42 or 3.1)."
        ),
    },
    "thinking": {
        "pre_prompt": COGMAP_TEMPLATE,
        "mca_post_prompt": (
            " Please provide only the single option letter (e.g., A, B, C, "
            "D, etc.) within the <answer> </answer> tags."
        ),
        "na_post_prompt": (
            " Please provide the numerical value (e.g., 42 or 3.1) within "
            "the <answer> </answer> tags."
        ),
    },
}

_NUMBER_WORDS = {
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "eleven": "11", "twelve": "12", "thirteen": "13", "fourteen": "14",
    "fifteen": "15", "sixteen": "16", "seventeen": "17", "eighteen": "18",
    "nineteen": "19", "twenty": "20", "thirty": "30", "forty": "40",
    "fifty": "50", "sixty": "60", "seventy": "70", "eighty": "80",
    "ninety": "90", "zero": "0", "a": "1", "an": "1",
}


def fuzzy_matching(pred: str) -> str:
    """MCQ letter extraction (vsi_util.py:120-126)."""
    m = re.search(r"^[A-D]\.?$", pred.split(" ")[0].strip())
    if m:
        return m.group(0).rstrip(".").upper().strip()
    return pred.strip()


def fuzzy_matching_num(pred: str) -> str:
    pred = pred.strip().lower()
    for word, digit in _NUMBER_WORDS.items():
        if re.search(r"\b" + word + r"\b", pred):
            return digit
    m = re.search(r"(\d+(\.\d+)?)", pred)
    if m:
        return m.group(1)
    return "None"


def vsibench_process_results(doc: dict) -> dict:
    if doc["question_type"] in MCA_QUESTION_TYPES:
        doc["predicted_answer"] = doc["predicted_answer"].replace("Answer:", "")
        doc["accuracy"] = exact_match(
            fuzzy_matching(doc["predicted_answer"]), doc["ground_truth"]
        )
    elif doc["question_type"] in NA_QUESTION_TYPES:
        try:
            doc["MRA:.5:.95:.05"] = mean_relative_accuracy(
                to_float(fuzzy_matching_num(doc["predicted_answer"])),
                to_float(doc["ground_truth"]),
            )
        except TypeError:
            doc["MRA:.5:.95:.05"] = 0.0
    else:
        raise ValueError(f"Unknown question type: {doc['question_type']}")
    return doc


def vsibench_aggregate_results(results: list[dict]) -> dict:
    by_type = defaultdict(list)
    for doc in results:
        qt = doc["question_type"]
        if qt in MCA_QUESTION_TYPES:
            by_type[f"{qt}_accuracy"].append(doc["accuracy"])
        elif qt in NA_QUESTION_TYPES:
            by_type[f"{qt}_MRA:.5:.95:.05"].append(doc["MRA:.5:.95:.05"])
        else:
            raise ValueError(f"Unknown question type: {qt}")
    output = {k: float(np.mean(v)) for k, v in by_type.items()}
    try:
        output["object_rel_direction_accuracy"] = (
            output.pop("object_rel_direction_easy_accuracy")
            + output.pop("object_rel_direction_medium_accuracy")
            + output.pop("object_rel_direction_hard_accuracy")
        ) / 3.0
    except KeyError:
        output["object_rel_direction_accuracy"] = 0
    output["overall_accuracy"] = sum(output.values()) / len(output)
    return output


def vsibench_eval(jsonl_path: str, mode: str = "thinking") -> dict:
    results = []
    for doc in read_jsonl(jsonl_path):
        if mode in ("thinking", "thinking_map") and "<answer>" in doc["predicted_answer"]:
            doc["predicted_answer"] = extract_answer_text(doc["predicted_answer"])
        results.append(vsibench_process_results(doc))
    return vsibench_aggregate_results(results)


def build_prompt(row: dict, prompt_type: str = "thinking") -> str:
    tpl = PROMPT_TEMPLATES.get(prompt_type, PROMPT_TEMPLATES["default"])
    question = row["question"]
    options = row.get("options")
    if options is not None and len(options) > 0:
        options = list(options)
        question += "\nOptions:\n" + "\n".join(options)
    if prompt_type == "thinking":
        text = tpl["pre_prompt"].format(
            Question=question, object_list=OBJECT_LIST, map_example=EXAMPLE_MAP
        )
    else:
        text = tpl["pre_prompt"].format(Question=question)
    if row["question_type"] in MCA_QUESTION_TYPES:
        text += "\n" + tpl["mca_post_prompt"]
    elif row["question_type"] in NA_QUESTION_TYPES:
        text += "\n" + tpl["na_post_prompt"]
    return text


def evaluate_vsibench(
    rank, world_size, data_file, video_dir, engine, output_dir, *,
    num_frames=32, fps=1, target_resolution=(448, 448), debug=False,
    batch_size=1, debug_size=4, prompt_type="thinking",
    max_new_tokens=None, serving="static", temperature=0.01,
):
    import pandas as pd

    df = pd.read_parquet(data_file)
    rows = df.to_dict("records")

    def build_sample(row):
        video_path = os.path.join(
            video_dir, row["dataset"], f"{row['scene_name']}.mp4"
        )
        if not os.path.exists(video_path):
            return None
        frames, timestamps, duration = load_video_frames(
            video_path, num_frames, fps, target_resolution
        )
        if frames is None:
            return None
        prompt_text = build_prompt(row, prompt_type)
        messages = [{
            "role": "user",
            "content": [
                {"type": "video", "video": frames},
                {"type": "text", "text": prompt_text},
            ],
        }]
        record = {
            "id": row["id"],
            "dataset": row["dataset"],
            "scene_name": row["scene_name"],
            "question": row["question"],
            "ground_truth": row["ground_truth"],
            "question_type": row["question_type"],
            "promt": prompt_text,
            "frame_timestamps": timestamps,
            "video_duration": duration,
        }
        return messages, record

    max_new = max_new_tokens if max_new_tokens is not None else (
        128 if prompt_type == "default" else 1024)
    return run_worker(
        task="VSI-Bench", rank=rank, world_size=world_size, rows=rows,
        build_sample=build_sample, engine=engine, output_dir=output_dir,
        batch_size=batch_size, serving=serving, max_new_tokens=max_new,
        temperature=temperature,
        debug=debug, debug_size=debug_size,
    )
