# Copied from spacer_tpu/evalharness/benchmarks/sparbench.py; only its imports point at spacer_tpu_torch.
"""SPAR-Bench worker + scorer.

Behavioral reference: SpaceR-Eval/data_utils/sparbench.py (+ spar_util.py):
multi-image prompts from parquet frame bytes (:183-199), per-task MCA/NA/
view-change-infer scoring (spar_util.py:248-279), Low/Middle/High tier and
per-image-type aggregation (:281-372), lenient exact match (:211-223) and
the zero-safe relative error (:225-230).
"""

from __future__ import annotations

import base64
import re
from collections import defaultdict

import numpy as np

from spacer_tpu_torch.evalharness.benchmarks.common import (
    mean_relative_accuracy,
    run_worker,
    to_float,
)
from spacer_tpu_torch.evalharness.util import extract_answer_text, read_jsonl

MCA_QUESTION_TYPES = [
    "obj_spatial_relation_oo", "obj_spatial_relation_oc_mv",
    "obj_spatial_relation_oo_mv", "spatial_imagination_oc",
    "spatial_imagination_oo", "spatial_imagination_oc_mv",
    "spatial_imagination_oo_mv", "position_matching",
    "camera_motion_infer", "distance_infer_center_oo",
    "distance_infer_center_oo_mv",
]
NA_QUESTION_TYPES = [
    "depth_prediction_oc", "depth_prediction_oo",
    "distance_prediction_oc", "distance_prediction_oo",
    "depth_prediction_oc_mv", "depth_prediction_oo_mv",
    "distance_prediction_oo_mv", "distance_prediction_oc_mv",
]
SPECIAL_QUESTION_TYPES = ["view_change_infer"]

LOW_TIER = list(NA_QUESTION_TYPES)
MIDDLE_TIER = ["view_change_infer", "position_matching", "camera_motion_infer"]
HIGH_TIER = [
    "obj_spatial_relation_oo", "obj_spatial_relation_oc_mv",
    "obj_spatial_relation_oo_mv", "spatial_imagination_oc",
    "spatial_imagination_oo", "spatial_imagination_oc_mv",
    "spatial_imagination_oo_mv", "distance_infer_center_oo",
    "distance_infer_center_oo_mv",
]

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
        "na_post_prompt": (
            "Please answer the question using a numerical value "
            "(e.g., 42 or 3.1)."
        ),
        "special_post_prompt": "Please output the answer directly.",
    },
    "thinking": {
        "pre_prompt": QUESTION_TEMPLATE,
        "mca_post_prompt": (
            "Please provide only the single option letter (e.g., A, B, C, D, "
            "etc.) within the <answer> </answer> tags."
        ),
        "na_post_prompt": (
            "Please provide the numerical value (e.g., 42 or 3.1) within the "
            "<answer> </answer> tags."
        ),
        "special_post_prompt": (
            "First output the thinking process in <think> </think> tags and "
            "then output the answer in <answer> </answer> tags."
        ),
    },
}


def exact_match_lenient(pred: str, target: str) -> float:
    """spar_util.py:211-223: exact, substring-of-target, or first char."""
    pred = pred.lower()
    target = target.lower()
    if pred == target:
        return 1.0
    if pred in target:
        return 1.0
    if pred[0] == target:
        return 1.0
    return 0.0


def process_na(pred: str, task: str):
    """Extract the numeric answer (spar_util.py:103-117): first number, or
    for _mv depth/distance tasks the LAST number (fallback -1)."""
    numbers = re.findall(r"(?<!\^)\d+\.\d+|(?<!\^)\d+", pred)
    extracted = [float(n) if "." in n else int(n) for n in numbers]
    if task in ["depth_prediction_oc_mv", "depth_prediction_oo_mv",
                "distance_prediction_oc_mv", "distance_prediction_oo_mv"]:
        if not extracted:
            extracted = [-1]
        extracted = [extracted[-1]]
    return extracted[0]


def parse_instruction(instruction: str) -> dict:
    return {
        k: float(v)
        for k, v in [item.split(":") for item in instruction.split(",")]
    }


def compute_vci_metric(pred: str, answer: str) -> float:
    """View-change-infer: MRA over 5 signed action-pair magnitudes
    (spar_util.py:126-167)."""
    answer_dict = parse_instruction(pred)
    gt_dict = parse_instruction(answer)
    pairs = [
        ("move_right", "move_left"),
        ("move_up", "move_down"),
        ("move_forward", "move_backward"),
        ("rotate_right", "rotate_left"),
        ("rotate_up", "rotate_down"),
    ]
    mra_list = []
    for pos, neg in pairs:
        a = answer_dict.get(pos, 0) - answer_dict.get(neg, 0)
        g = gt_dict.get(pos, 0) - gt_dict.get(neg, 0)
        # reference calls mean_relative_accuracy(gt, answer) with gt as
        # "pred" — preserve the argument order (relative error w.r.t. the
        # prediction), including divide-by-zero -> inf -> 0 accuracy
        mra_list.append(
            mean_relative_accuracy(g, a, zero_safe=True)
        )
    return float(np.mean(mra_list))


def sparbench_process_results(doc: dict) -> dict:
    task = doc["task"]
    if task in MCA_QUESTION_TYPES:
        doc["accuracy"] = exact_match_lenient(
            doc["predicted_answer"], doc["ground_truth"]
        )
    elif task in NA_QUESTION_TYPES:
        try:
            doc["MRA:.5:.95:.05"] = mean_relative_accuracy(
                to_float(process_na(doc["predicted_answer"], task)),
                to_float(doc["ground_truth"]),
                zero_safe=True,
            )
        except Exception:
            doc["MRA:.5:.95:.05"] = 0.0
    elif task in SPECIAL_QUESTION_TYPES:
        try:
            doc["vci_metric"] = compute_vci_metric(
                doc["predicted_answer"], doc["ground_truth"]
            )
        except Exception:
            doc["vci_metric"] = 0
    else:
        raise ValueError(f"Unknown question type: {task}")
    return doc


def _aggregate_group(docs: list[dict], literal_vci_key: bool = False) -> dict:
    by_task = defaultdict(list)
    for doc in docs:
        task = doc["task"]
        if task in MCA_QUESTION_TYPES:
            by_task[f"{task}_accuracy"].append(doc["accuracy"])
        elif task in NA_QUESTION_TYPES:
            by_task[f"{task}_MRA:.5:.95:.05"].append(doc["MRA:.5:.95:.05"])
        elif task in SPECIAL_QUESTION_TYPES:
            # reference quirk (spar_util.py:326): the by-img-type branch is
            # missing the f-string prefix, so vci lands under the literal
            # key "{question_type}_vci_metric"
            key = ("{question_type}_vci_metric" if literal_vci_key
                   else f"{task}_vci_metric")
            by_task[key].append(doc["vci_metric"])
    out = {k: float(np.mean(v)) for k, v in by_task.items()}
    out["overall_accuracy"] = sum(out.values()) / len(out) if out else 0.0
    return out


def _add_tiers(group_output: dict) -> None:
    low, middle, high = [], [], []
    for task, value in list(group_output.items()):
        if task in ("overall_accuracy", "Low", "Middle", "High"):
            continue
        task_name = "_".join(task.split("_")[:-1])
        if task_name in LOW_TIER:
            low.append(value)
        elif task_name in MIDDLE_TIER:
            middle.append(value)
        elif task_name in HIGH_TIER:
            high.append(value)
    group_output["Low"] = float(np.mean(low)) if low else float("nan")
    group_output["Middle"] = float(np.mean(middle)) if middle else float("nan")
    group_output["High"] = float(np.mean(high)) if high else float("nan")


def sparbench_aggregate_results(results: list[dict]) -> dict:
    overall = _aggregate_group(results)
    by_img = {}
    img_groups = defaultdict(list)
    for doc in results:
        img_groups[doc["image_type"]].append(doc)
    for img_type, docs in img_groups.items():
        by_img[img_type] = _aggregate_group(docs, literal_vci_key=True)
        _add_tiers(by_img[img_type])
    _add_tiers(overall)
    return {"overall": overall, "by_img_type": by_img}


def sparbench_eval(jsonl_path: str, mode: str = "thinking") -> dict:
    results = []
    for doc in read_jsonl(jsonl_path):
        if mode == "thinking" and "<answer>" in doc["predicted_answer"]:
            doc["predicted_answer"] = extract_answer_text(doc["predicted_answer"])
        if doc["predicted_answer"] is None:
            doc["predicted_answer"] = "None"
        results.append(sparbench_process_results(doc))
    return sparbench_aggregate_results(results)


def build_prompt(row: dict, prompt_type: str = "thinking") -> str:
    tpl = PROMPT_TEMPLATES.get(prompt_type, PROMPT_TEMPLATES["default"])
    prompt_text = tpl["pre_prompt"].format(Question=row["question"])
    task = row["task"]
    if task in NA_QUESTION_TYPES:
        prompt_text += "\n" + tpl["na_post_prompt"]
    elif task in MCA_QUESTION_TYPES:
        post = ""
        if task in ("position_matching", "camera_motion_infer"):
            post = (
                "The values represent the bounding box coordinates "
                "normalized to a 0-1000 scale, with the top-left corner as "
                "the origin of the image."
            )
        prompt_text += "\n" + post + "\n" + tpl["mca_post_prompt"]
    elif task in SPECIAL_QUESTION_TYPES:
        prompt_text += "\n" + tpl["special_post_prompt"]
    else:
        raise ValueError(f"Unknown question type: {task}")
    return prompt_text


def evaluate_sparbench(
    rank, world_size, data_files, video_dir, engine, output_dir, *,
    num_frames=32, fps=1, target_resolution=(448, 448), debug=False,
    batch_size=1, debug_size=4, prompt_type="thinking",
    max_new_tokens=None, serving="static", temperature=0.01,
):
    import os

    import pandas as pd

    frames = []
    for path in data_files:
        if os.path.exists(path):
            frames.append(pd.read_parquet(path))
    rows = pd.concat(frames, ignore_index=True).to_dict("records")

    def build_sample(row):
        prompt_text = build_prompt(row, prompt_type)
        content = []
        for img in row["image"]:
            b64 = base64.b64encode(img["bytes"]).decode("utf-8")
            content.append({"type": "image", "image": f"data:image;base64,{b64}"})
        content.append({"type": "text", "text": prompt_text})
        messages = [{"role": "user", "content": content}]
        record = {
            "id": row["id"],
            "question": row["question"],
            "ground_truth": row["answer"],
            "task": row["task"],
            "image_type": row["img_type"],
            "promt": prompt_text,
        }
        return messages, record

    max_new = max_new_tokens if max_new_tokens is not None else (
        128 if prompt_type == "default" else 1024)
    return run_worker(
        task="SPAR-Bench", rank=rank, world_size=world_size, rows=rows,
        build_sample=build_sample, engine=engine, output_dir=output_dir,
        batch_size=batch_size, serving=serving, max_new_tokens=max_new,
        temperature=temperature,
        debug=debug, debug_size=debug_size,
    )
