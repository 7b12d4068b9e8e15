# Copied from spacer_tpu/data/templates.py (stdlib / numpy only; no JAX).
"""Prompt templates and conversation construction (SG-RLVR.py parity).

Behavioral reference: SG-RLVR.py:252-352 — SYSTEM_PROMPT (:252-257),
QUESTION_TEMPLATE (:293-299), TYPE_TEMPLATE (:301-307), COGMAP_TEMPLATE
(:308-318), make_conversation_image_and_video_map (:319-352).
"""

from __future__ import annotations

import os

SYSTEM_PROMPT = (
    "A conversation between User and Assistant. The user asks a question, "
    "and the Assistant solves it. The assistant first thinks about the "
    "reasoning process in the mind and then provides the user with the "
    "answer. The reasoning process and answer are enclosed within <think> "
    "</think> and <answer> </answer> tags, respectively, i.e., <think> "
    "reasoning process here </think><answer> answer here </answer>"
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

TYPE_TEMPLATE = {
    "multiple choice": (
        " Please provide only the single option letter (e.g., A, B, C, D, "
        "etc.) within the <answer> </answer> tags."
    ),
    "numerical": (
        " Please provide the numerical value (e.g., 42 or 3.1) within the "
        "<answer> </answer> tags."
    ),
    "OCR": (
        " Please transcribe text from the image/video clearly and provide "
        "your text answer within the <answer> </answer> tags."
    ),
    "free-form": (
        " Please provide your text answer within the <answer> </answer> tags."
    ),
    "regression": (
        " Please provide the numerical value (e.g., 42 or 3.14) within the "
        "<answer> </answer> tags."
    ),
}

COGMAP_TEMPLATE = (
    "Question: {Question}\n"
    "Please think about this question as if you were a human pondering deeply. "
    "Engage in an internal dialogue using expressions such as 'let me think', "
    "'wait', 'Hmm', 'oh, I see', 'let's break it down', etc, or other natural "
    "language thought expressions "
    "It's encouraged to include self-reflection or verification in the "
    "reasoning process.\n"
    "If generating a cognitive map for the video can help you answer the "
    "question, you could follow the below steps to generate a cognitive map "
    "in <map> </map> tags\n"
    "[Steps] Identify specific objects within the **video scene**, understand "
    "the spatial arrangement of the scene, and estimate the center point of "
    "each object, assuming the entire scene is represented by a 10x10 grid. "
    "These information should be summarized in <map> </map> tags.\n"
    "[Rule]1. We provide the categories to care about in this scene: "
    "{object_list}. Focus ONLY on these categories for the entire video "
    "scene.\n2. Estimate the center location of each instance within the "
    "provided categories, assuming the entire scene is represented by a "
    "10x10 grid, considering the information from all frames.\n3. If a "
    "category contains multiple instances across all frames, include all of "
    "them.\n"
    "Present the map using dict format. Here is an example: "
    "<map>{map_example}</map>.\n"
    "If you generate a cognitive map, please put it in <map> </map> tags. "
    "Provide your detailed reasoning process between the <think> </think> "
    "tags, and then give your final answer between the <answer> </answer> "
    "tags."
)

EXAMPLE_MAP = {"table": [[0, 3], [5, 7]], "chair": [[9, 3]], "window": [[6, 5]]}


def make_conversation(example: dict, map_data: dict | None = None) -> dict:
    """Dataset row -> {'prompt': [...]} message list.

    Parity with make_conversation_image_and_video_map (SG-RLVR.py:319-352):
    MC options appended to the question; SR_dataset rows with a known
    cognitive map get the COGMAP prompt, others the plain QUESTION prompt.
    """
    if example["problem_type"] == "multiple choice":
        question = example["problem"] + "Options:\n"
        for op in example["options"]:
            question += op + "\n"
    else:
        question = example["problem"]

    if example.get("data_source") == "SR_dataset" and map_data is not None:
        video_id = os.path.splitext(os.path.basename(example["path"]))[0]
        object_list = list(map_data[video_id]["cognitive_map"].keys())
        prompt = (
            COGMAP_TEMPLATE.format(
                Question=question, object_list=object_list,
                map_example=EXAMPLE_MAP,
            )
            + TYPE_TEMPLATE[example["problem_type"]]
        )
    else:
        prompt = (
            QUESTION_TEMPLATE.format(Question=question)
            + TYPE_TEMPLATE[example["problem_type"]]
        )

    return {
        "prompt": [
            {
                "role": "user",
                "content": [
                    {"type": example["data_type"]},
                    {"type": "text", "text": prompt},
                ],
            }
        ]
    }
