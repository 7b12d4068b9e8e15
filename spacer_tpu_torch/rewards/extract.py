# Copied from spacer_tpu/rewards/extract.py (stdlib / numpy only; no JAX).
"""Tag extraction helpers shared by rewards and eval scorers."""

from __future__ import annotations

import re

_ANSWER_RE = re.compile(r"<answer>\s*(.*?)\s*</answer>", re.DOTALL)
_MAP_RE = re.compile(r"<map>\s*(.*?)\s*</map>", re.DOTALL)
_THINK_RE = re.compile(r"<think>\s*(.*?)\s*</think>", re.DOTALL)


def extract_answer(text: str) -> str:
    """Contents of the first <answer>...</answer> block, '' if absent
    (SG-RLVR.py:97-102 semantics)."""
    m = _ANSWER_RE.search(text or "")
    return m.group(1).strip() if m else ""


def extract_map_tag(text: str) -> str:
    """Contents of the first <map>...</map> block, '' if absent."""
    m = _MAP_RE.search(text or "")
    return m.group(1).strip() if m else ""


def extract_think(text: str) -> str:
    m = _THINK_RE.search(text or "")
    return m.group(1).strip() if m else ""
