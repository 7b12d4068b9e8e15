# Copied from spacer_tpu/rewards/accuracy.py; only its imports point at spacer_tpu_torch.
"""Accuracy reward over question types (multiple choice / numerical / OCR /
free-form / regression) with the cognitive-map bonus.

Behavioral reference: SG-RLVR.py:57-235.  Notable semantics preserved:
- fuzzy_matching maps number words ('one'..'ninety', including 'a'/'an'->1)
  before falling back to the first numeric literal, else "None".
- numerical scoring is Mean Relative Accuracy over thresholds
  linspace(0.5, 0.95, 11).
- map bonus: when the answer is correct (MC exact, or MRA > 0.5) and the
  completion contains a <map> block, the map score is ADDED to the reward if
  positive, else the whole reward is zeroed (SG-RLVR.py:177-202).
- any exception inside a sample's scoring yields reward 0.0 for that sample.
"""

from __future__ import annotations

import os
import re
from datetime import datetime

import numpy as np

from spacer_tpu_torch.rewards.cogmap import compute_map_score
from spacer_tpu_torch.rewards.extract import extract_answer

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
    """Number-word / numeric-literal extraction (SG-RLVR.py:58-78)."""
    pred = pred.strip().lower()
    for word, digit in _NUMBER_WORDS.items():
        if re.search(r"\b" + word + r"\b", pred):
            return digit
    m = re.search(r"\d+(\.\d+)?", pred)
    if m:
        return m.group(0)
    return "None"


def to_float(pred):
    try:
        return float(pred)
    except BaseException:
        return None


def mean_relative_accuracy(pred, target, start=0.5, end=0.95, interval=0.05):
    """Mean over confidence thresholds of [relative error <= 1 - threshold].

    Matches SG-RLVR.py:91-95 exactly, including the (end-start)/interval + 2
    point count (11 thresholds for the default range).
    """
    num_pts = (end - start) / interval + 2
    conf_intervs = np.linspace(start, end, int(num_pts))
    rel = abs(pred - target) / target
    return float((rel <= 1 - conf_intervs).mean())


def normalize_number(num_str):
    try:
        return float(str(num_str).replace(",", ""))
    except Exception:
        return None


def word_error_rate(reference: str, hypothesis: str) -> float:
    """Word-level Levenshtein / len(ref) (SG-RLVR.py:128-144)."""
    ref = reference.split()
    hyp = hypothesis.split()
    m, n = len(ref), len(hyp)
    d = list(range(n + 1))
    for i in range(1, m + 1):
        prev = d[0]
        d[0] = i
        for j in range(1, n + 1):
            cur = d[j]
            if ref[i - 1] == hyp[j - 1]:
                d[j] = prev
            else:
                d[j] = 1 + min(d[j], d[j - 1], prev)
            prev = cur
    return d[n] / max(1, m)


def rouge_average_fmeasure(reference: str, hypothesis: str,
                           use_stemmer: bool = True) -> float:
    from rouge_score import rouge_scorer

    scorer = rouge_scorer.RougeScorer(
        ["rouge1", "rouge2", "rougeL"], use_stemmer=use_stemmer
    )
    scores = scorer.score(reference, hypothesis)
    return (
        scores["rouge1"].fmeasure
        + scores["rouge2"].fmeasure
        + scores["rougeL"].fmeasure
    ) / 3


def _completion_text(completion) -> str:
    """Accept both conversational ([{'role','content'}]) and raw-string form."""
    if isinstance(completion, str):
        return completion
    return completion[0]["content"]


def accuracy_reward(completions, solution, path=None, map_data=None, **kwargs):
    """Per-completion accuracy rewards.

    Args:
      completions: list of completions (conversational or raw strings).
      solution: list of ground-truth strings (with <answer> tags).
      path: list of video paths (keys into `map_data` by basename-sans-ext).
      map_data: {video_id: {"cognitive_map": {...}, ...}} ground-truth maps;
        None disables the map bonus.
      kwargs: dataset columns; requires problem_type.
    """
    question_type = kwargs["problem_type"][0]
    contents = [_completion_text(c) for c in completions]
    if path is None:
        path = [None] * len(contents)
    if len(path) == 1 and len(contents) > 1:
        path = path * len(contents)
    current_time = datetime.now().strftime("%d-%H-%M-%S-%f")
    rewards = []

    def map_bonus(content, reward, pa):
        if map_data is None or pa is None:
            return reward
        if "<map>" not in content or "</map>" not in content:
            return reward
        video_id = os.path.splitext(os.path.basename(pa))[0]
        map_solution = map_data[video_id]
        cognitive_map = map_solution["cognitive_map"]
        object_list = list(cognitive_map.keys())
        score = compute_map_score(content, cognitive_map, object_list, 10)
        return reward + score if score > 0 else 0.0

    for content, sol, pa in zip(contents, solution, path):
        try:
            output_ans = extract_answer(content)
            gt_ans = extract_answer(sol)
            if question_type == "multiple choice":
                reward = 1.0 if output_ans.strip() == gt_ans.strip() else 0.0
                if reward == 1.0:
                    reward = map_bonus(content, reward, pa)
            elif question_type == "numerical":
                gt_number = to_float(gt_ans)
                out_number = to_float(fuzzy_matching(output_ans))
                if gt_number is None or out_number is None:
                    reward = 0.0
                else:
                    reward = mean_relative_accuracy(out_number, gt_number)
                    if reward > 0.5:
                        reward = map_bonus(content, reward, pa)
            elif question_type == "OCR":
                reward = max(0.0, min(1.0, 1 - word_error_rate(gt_ans, output_ans)))
            elif question_type == "free-form":
                reward = max(0.0, min(1.0, rouge_average_fmeasure(gt_ans, output_ans)))
            elif question_type == "regression":
                gt_number = normalize_number(gt_ans)
                out_number = normalize_number(output_ans)
                rel_diff = (abs(out_number - gt_number) + 1e-9) / (abs(gt_number) + 1e-9)
                reward = 1 - min(1.0, max(0.0, rel_diff))
            else:
                reward = 0.0
        except Exception:
            reward = 0.0
        rewards.append(reward)

        if os.getenv("DEBUG_MODE") == "true":
            log_path = os.getenv("LOG_PATH")
            if log_path:
                with open(log_path, "a", encoding="utf-8") as f:
                    f.write(
                        f"------------- {current_time} Accuracy reward: "
                        f"{reward} -------------\n"
                    )
                    f.write(f"Content: {content}\n")
                    f.write(f"Solution: {sol}\n")
    return rewards


# Explicit dispatch flag: the trainer passes `map_data` (the cognitive-map
# ground truth, SG-RLVR.py:290-291) only to reward functions that declare
# they need it.  An attribute — not a __name__ check — so wrappers/renames
# keep working as long as they carry the flag forward.
accuracy_reward.needs_map_data = True
