# Copied from spacer_tpu/data/dataset.py (stdlib / numpy only; no JAX).
"""Dataset loading: SpaceR-151k jsonl rows + cognitive-map annotations.

Behavioral reference: SG-RLVR.py:265-291 (jsonl load + map load) and
extract_map.py read_data (:21-105, multi-format reader).
"""

from __future__ import annotations

import csv
import json
import os
import pickle
from typing import Any, Iterator


def read_data(file_path: str, file_format: str | None = None):
    """Multi-format record reader (json/jsonl/pkl/parquet/csv/tsv).

    Returns a list of records, [] for an empty file, None on unsupported
    format or read error (extract_map.py:21-105 semantics).
    """
    try:
        if file_format is None:
            file_format = os.path.splitext(file_path)[1].lstrip(".").lower()
        if file_format == "json":
            with open(file_path, "r", encoding="utf-8") as f:
                data = json.load(f)
                if not isinstance(data, list):
                    f.seek(0)
                    data = [json.loads(line) for line in f]
        elif file_format == "jsonl":
            with open(file_path, "r", encoding="utf-8") as f:
                data = [json.loads(line) for line in f if line.strip()]
        elif file_format in ("pkl", "pickle"):
            with open(file_path, "rb") as f:
                data = pickle.load(f)
                if not isinstance(data, list):
                    data = list(data)
        elif file_format == "parquet":
            import pandas as pd

            data = pd.read_parquet(file_path).to_dict("records")
        elif file_format == "csv":
            with open(file_path, newline="", encoding="utf-8") as f:
                data = list(csv.DictReader(f))
        elif file_format == "tsv":
            with open(file_path, newline="", encoding="utf-8") as f:
                data = list(csv.DictReader(f, delimiter="\t"))
        else:
            return None
        return data if data else []
    except FileNotFoundError:
        return None
    except Exception:
        return None


def load_jsonl_dataset(path: str) -> list[dict]:
    """SpaceR-151k-style rows: problem / problem_type / options / solution /
    path / data_type / data_source / problem_id."""
    data = read_data(path)
    if data is None:
        raise FileNotFoundError(path)
    return data


def load_cognitive_maps(path: str) -> dict[str, dict]:
    """annotation/cognitive_map.jsonl -> {video_id: {cognitive_map,
    object_list}} (SG-RLVR.py:283-291)."""
    data = read_data(path)
    if data is None:
        raise FileNotFoundError(path)
    return {
        item["video_id"]: {
            "cognitive_map": item["cognitive_map"],
            "object_list": item["object_list"],
        }
        for item in data
    }


def shard_indices(n: int, rank: int, world_size: int) -> list[int]:
    """np.array_split-style contiguous sharding (evaluate.py:146-173 /
    vsibench.py:73-77 parity)."""
    import numpy as np

    return np.array_split(np.arange(n), world_size)[rank].tolist()


def iter_batches(rows: list, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False) -> Iterator[list]:
    import numpy as np

    order = np.arange(len(rows))
    if shuffle:
        order = np.random.default_rng(seed).permutation(order)
    for i in range(0, len(order), batch_size):
        chunk = order[i : i + batch_size]
        if drop_last and len(chunk) < batch_size:
            return
        yield [rows[int(j)] for j in chunk]
