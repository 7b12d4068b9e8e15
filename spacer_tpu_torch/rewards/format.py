# Copied from spacer_tpu/rewards/format.py (stdlib / numpy only; no JAX).
"""Format reward: full-match <think>...</think><answer>...</answer>.

Behavioral reference: SG-RLVR.py:238-244 (re.fullmatch with DOTALL, optional
whitespace between the blocks).
"""

from __future__ import annotations

import re

_FORMAT_RE = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>", re.DOTALL)


def format_reward(completions, **kwargs):
    contents = [
        c if isinstance(c, str) else c[0]["content"] for c in completions
    ]
    return [1.0 if _FORMAT_RE.fullmatch(c) else 0.0 for c in contents]
