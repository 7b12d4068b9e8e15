# Copied from spacer_tpu/rewards/cogmap.py; only its imports point at spacer_tpu_torch.
"""Cognitive-map parsing and grid-localization scoring.

Behavioral reference: extract_map.py — extract_map_data (:497-584, dict
literal parse with robust positional fallback :324-494), coordinate pair
validation (:112-233), and calculate_prediction_score (:621-773: greedy
nearest matching, point accuracy 1 - dist/(N*sqrt(2)), per-type accuracy
divided by max(n_res, n_sol), weighted by solution counts).

The model emits a 10x10-grid map inside <map>...</map>; the reward compares
it against the ground-truth map from annotation/cognitive_map.jsonl.
"""

from __future__ import annotations

import ast
import math
import re
from collections import defaultdict
from typing import Any

_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?")
_ELEM_CLEAN_RE = re.compile(r"^[<\[(]*(-?\d+(?:\.\d+)?)[>\])]*$")
_KEY_CLEAN_RE = re.compile(r"^[^\w\s]*([\w\s]+)[^\w\s]*$")


def _validate_pair(coord: Any) -> list[int] | None:
    """Coerce one coordinate pair to [int, int] or reject (extract_map.py:112)."""
    elements = None
    if isinstance(coord, (list, tuple)):
        if len(coord) == 2:
            elements = list(coord)
        elif len(coord) == 1:
            inner = coord[0]
            if isinstance(inner, (list, tuple)) and len(inner) == 2:
                elements = list(inner)
            else:
                return None
        else:
            return None
    elif isinstance(coord, str):
        nums = _NUM_RE.findall(coord)
        if len(nums) < 2:
            return None
        elements = nums[:2]
    else:
        return None

    numeric = []
    for n in elements:
        if isinstance(n, (int, float)):
            numeric.append(n)
        elif isinstance(n, str):
            s = n.strip()
            m = _ELEM_CLEAN_RE.match(s)
            if m:
                s = m.group(1)
            try:
                numeric.append(float(s))
            except (ValueError, TypeError):
                return None
        else:
            return None
    if len(numeric) != 2:
        return None
    try:
        return [int(x) for x in numeric]
    except (ValueError, TypeError, OverflowError):
        return None


def _validate_coord_list(value: Any, _name: str = "") -> list[list[int]]:
    if not isinstance(value, list):
        single = _validate_pair(value)
        return [single] if single else []
    out = []
    for item in value:
        pair = _validate_pair(item)
        if pair is not None:
            out.append(pair)
    return out


def _from_dict(parsed: dict, object_set: set[str]) -> dict[str, list[list[int]]]:
    result = defaultdict(list)
    for key, value in parsed.items():
        key_str = str(key).lower().strip()
        m = _KEY_CLEAN_RE.match(key_str)
        key_lower = m.group(1).strip() if m else key_str
        if key_lower in object_set:
            coords = _validate_coord_list(value, key_lower)
            if coords:
                result[key_lower].extend(coords)
    return dict(result)


def _from_string_robust(
    map_string: str, object_set: set[str], object_list: list[str]
) -> dict[str, list[list[int]]]:
    """Positional fallback: locate object names (whole-word, longest-match,
    non-overlapping), then pair up numbers found after each name."""
    occurrences = []
    for name in object_list:
        if not name or not isinstance(name, str):
            continue
        lower = name.lower()
        if lower not in object_set:
            continue
        pattern = re.compile(
            r"(?<![a-zA-Z])" + re.escape(name) + r"(?![a-zA-Z])", re.IGNORECASE
        )
        for m in pattern.finditer(map_string):
            occurrences.append({"name": lower, "start": m.start(), "end": m.end()})
    if not occurrences:
        return {}

    occurrences.sort(key=lambda o: (o["start"], -o["end"]))
    filtered = [occurrences[0]]
    for occ in occurrences[1:]:
        last = filtered[-1]
        if occ["start"] < last["end"]:
            if occ["end"] <= last["end"]:
                continue  # fully covered by the accepted (longer) match
            filtered[-1] = occ  # extends further: replace
        else:
            filtered.append(occ)

    result = defaultdict(list)
    processed: set[tuple[int, int]] = set()
    for i, occ in enumerate(filtered):
        region_start = occ["end"]
        region_end = (
            filtered[i + 1]["start"] if i + 1 < len(filtered) else len(map_string)
        )
        if region_start >= region_end:
            continue
        for p_start, p_end in processed:
            if p_start <= region_start < p_end:
                region_start = p_end
        if region_start >= region_end:
            continue
        nums = _NUM_RE.findall(map_string[region_start:region_end])
        coords = []
        for j in range(0, len(nums) - 1, 2):
            pair = _validate_pair((nums[j], nums[j + 1]))
            if pair:
                coords.append(pair)
        if coords:
            result[occ["name"]].extend(coords)
        processed.add((region_start, region_end))
    return dict(result)


def extract_map_data(map_string: str, object_list: list[str]) -> dict[str, list[list[int]]]:
    """Parse a model-emitted map string -> {object_name: [[x, y], ...]}.

    Tries a python dict literal first; falls back to robust positional
    extraction.  Object names are matched case-insensitively against
    `object_list`; keys in the result are lowercase.
    """
    if not isinstance(map_string, str) or not map_string:
        return {}
    if not isinstance(object_list, list):
        return {}
    valid_names = [n for n in object_list if isinstance(n, str) and n]
    object_set = {n.lower() for n in valid_names}
    if not object_set:
        return {}

    stripped = map_string.strip()
    cleaned = stripped
    if cleaned.startswith("str{") and cleaned.endswith("}"):
        inner = cleaned[4:-1].strip()
        if inner.startswith("{") and inner.endswith("}"):
            cleaned = inner

    if cleaned.startswith("{") and cleaned.endswith("}"):
        try:
            parsed = ast.literal_eval(cleaned)
            if isinstance(parsed, dict):
                return _from_dict(parsed, object_set)
        except Exception:
            pass
    return _from_string_robust(stripped, object_set, valid_names)


def calculate_prediction_score(
    response: dict[str, list], solution: dict[str, list], grid_size_n: int
) -> float:
    """Weighted localization accuracy in [0, 1] (extract_map.py:621-773)."""
    if grid_size_n <= 0:
        raise ValueError("Grid size N must be positive.")
    max_distance = max(grid_size_n * math.sqrt(2.0), 1e-9)

    all_types = set(response) | set(solution)
    if not all_types:
        return 1.0

    weighted_sum = 0.0
    total_weight = 0
    for obj_type in all_types:
        res = response.get(obj_type, [])
        sol = solution.get(obj_type, [])
        n_res, n_sol = len(res), len(sol)
        total_weight += n_sol
        denom = max(n_res, n_sol)
        if denom == 0:
            acc = 1.0
        elif n_res == 0 or n_sol == 0:
            acc = 0.0
        else:
            pairs = sorted(
                (math.dist(r[:2], s[:2]), ri, si)
                for ri, r in enumerate(res)
                for si, s in enumerate(sol)
            )
            used_r: set[int] = set()
            used_s: set[int] = set()
            acc_sum = 0.0
            matched = 0
            for dist, ri, si in pairs:
                if ri in used_r or si in used_s:
                    continue
                acc_sum += max(0.0, 1.0 - dist / max_distance)
                used_r.add(ri)
                used_s.add(si)
                matched += 1
                if matched == min(n_res, n_sol):
                    break
            acc = acc_sum / denom
        weighted_sum += acc * n_sol

    if total_weight == 0:
        # Reference parity: with an all-empty solution, any response KEY (even
        # with an empty coord list) trips a latent TypeError in the reference
        # (extract_map.py:763) which callers convert to reward 0.0; an empty
        # response dict scores 1.0.
        return 1.0 if not response else 0.0
    return weighted_sum / total_weight


def compute_map_score(content: str, solution_map: dict, object_list: list[str],
                      grid_size_n: int = 10) -> float:
    """Extract the <map> tag from `content`, parse, and score against the
    ground truth (SG-RLVR.py:147-157 semantics)."""
    from spacer_tpu_torch.rewards.extract import extract_map_tag

    map_response = extract_map_tag(content)
    parsed = extract_map_data(map_response, object_list)
    return calculate_prediction_score(parsed, solution_map, grid_size_n)
