# Copied from spacer_tpu/evalharness/text_tasks.py (stdlib / numpy only; no JAX).
"""Text-math eval tasks (aime24 / math_500).

Reference parity: open_r1/evaluate.py (lighteval task configs for boxed-math
answer matching).  Instead of depending on lighteval, this module provides
the same task descriptors plus a self-contained boxed/numeric answer matcher
and a runner over the framework's own sampler engine.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class TextTask:
    name: str
    hf_repo: str
    split: str
    generation_size: int = 32768


AIME24 = TextTask("aime24", "HuggingFaceH4/aime_2024", "train")
MATH_500 = TextTask("math_500", "HuggingFaceH4/MATH-500", "test")
TASKS_TABLE = [AIME24, MATH_500]


_BOXED_RE = re.compile(r"\\boxed\{([^{}]*(?:\{[^{}]*\}[^{}]*)*)\}")
_NUM_RE = re.compile(r"-?\d+(?:[.,]\d+)?(?:/\d+)?")


def extract_boxed(text: str) -> str | None:
    """Last \\boxed{...} content, else the last numeric expression."""
    boxed = _BOXED_RE.findall(text or "")
    if boxed:
        return boxed[-1].strip()
    nums = _NUM_RE.findall(text or "")
    return nums[-1] if nums else None


def _canon(s: str) -> str:
    s = s.strip().replace(",", "").replace("$", "")
    s = re.sub(r"\\(text|mathrm)\{([^}]*)\}", r"\2", s)
    s = s.replace("\\left", "").replace("\\right", "")
    s = re.sub(r"\s+", "", s)
    try:
        f = float(eval(s, {"__builtins__": {}}))  # handles fractions "3/4"
        return f"{f:.5f}".rstrip("0").rstrip(".")
    except Exception:
        return s


def math_answer_match(pred: str, gold: str) -> float:
    """First-match extractive comparison at 5-digit precision (mirrors the
    reference's multilingual_extractive_match_metric configuration)."""
    p = extract_boxed(pred)
    g = extract_boxed(gold) or gold
    if p is None:
        return 0.0
    return 1.0 if _canon(p) == _canon(g) else 0.0


def evaluate_text_task(
    task: TextTask,
    rows: Sequence[dict],
    generate: Callable[[list[str]], list[str]],
    batch_size: int = 8,
) -> dict:
    """rows: dicts with problem/solution. generate: prompts -> completions."""
    scores = []
    for start in range(0, len(rows), batch_size):
        batch = rows[start : start + batch_size]
        outs = generate([r["problem"] for r in batch])
        for r, o in zip(batch, outs):
            scores.append(math_answer_match(o, r["solution"]))
    return {
        "task": task.name,
        "accuracy": sum(scores) / len(scores) if scores else 0.0,
        "n": len(scores),
    }
