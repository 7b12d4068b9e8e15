"""The traffic generator: the same seed gives the same deck and schedule;
every seed gives the same multiset of sizes and gaps in another order."""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import requests, traffic  # noqa: E402

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def load(mix):
    return json.loads((BENCH / "traffic" / f"{mix}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_deck_is_the_seeds_and_its_sizes_are_every_seeds(mix):
    tr = load(mix)
    n = traffic.request_count(tr, 45)
    a, b = traffic.deck(tr["fields"], n, 2 ** 31 + 7), traffic.deck(tr["fields"], n, 2 ** 31 + 7)
    c = traffic.deck(tr["fields"], n, 12)
    assert a == b and a != c
    for field in tr["fields"]:
        assert sorted(r[field] for r in a) == sorted(r[field] for r in c)
    ta, tc = traffic.arrivals(tr["arrivals"], n, 3), traffic.arrivals(tr["arrivals"], n, 4)
    assert np.array_equal(ta, traffic.arrivals(tr["arrivals"], n, 3))
    assert np.allclose(np.sort(np.diff(ta, prepend=0)), np.sort(np.diff(tc, prepend=0)))


def test_quantiles_of_each_kind():
    assert traffic.quantiles({"kind": "uniform_int", "low": 1, "high": 8}, 8).tolist() == \
        list(range(1, 9))
    q = traffic.quantiles({"kind": "loguniform_int", "low": 16, "high": 256}, 1000)
    assert q.min() == 16 and q.max() == 256
    assert abs(np.median(q) - 64) <= 2          # geometric middle of 16 and 257
    assert traffic.quantiles({"kind": "choice", "values": [8, 16, 24, 32]}, 8).tolist() == \
        [8, 8, 16, 16, 24, 24, 32, 32]
    gaps = np.diff(traffic.arrivals({"kind": "poisson", "rate_per_s": 5.0}, 2000, 1))
    assert abs(gaps.mean() - 0.2) < 0.01


def test_video_inputs_are_the_seeds():
    import torch

    cfg = json.loads((BENCH / "configs/qwen25vl7b.json").read_text())
    tr = load("video_qa")
    shapes = [{"video_frames": 8, "question_tokens": 40, "max_new_tokens": 16},
              {"video_frames": 32, "question_tokens": 256, "max_new_tokens": 16}]
    a = requests.build(cfg, tr["prompt"], shapes, 99, torch.device("cpu"))
    b = requests.build(cfg, tr["prompt"], shapes, 99, torch.device("cpu"))
    assert a[1]["grid"] == (16, 16, 30) and a[1]["pixels"].shape == (7680, 1176)
    m = cfg["model"]
    assert (a[1]["ids"] == m["video_token_id"]).sum() == 1920
    assert len(a[1]["ids"]) == 8 + 2 + 1920 + 256 + 5 <= tr["serving"]["prompt_len"]
    assert all(np.array_equal(x["ids"], y["ids"]) and torch.equal(x["pixels"], y["pixels"])
               for x, y in zip(a, b))
