"""The control: the reference itself computed with float8 products, put in
the program's place, must come out not correct.  On the CPU at tiny sizes
(the Qwen cell, whose tiny limit the float8 products exceed) and, marked
`gpu`, on the card at each real cell's own sizes and limit."""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import tiny  # noqa: E402
from harness import check, spec  # noqa: E402
from reference.common import Precision, gaps  # noqa: E402

REAL = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def readings(bench, workload, seed, seconds, device):
    """One window of the cell -> (the program's number, the control's
    number, the limit) for the gap number the cell's limits file names;
    the control read at the positions of the sample the check takes."""
    from calibrate import served_run

    cell = spec.resolve(workload, bench)
    s, run = served_run(cell, seed, seconds, device)
    picked = check.sample(run.requests, seed, cell.limits["min_served_tokens"],
                          cell.limits["max_requests"])
    items = check.items(s, run.requests, picked)
    ref = check.reference_module(cell.config["family"])
    f32 = ref.served_logits(s.params, cell.config["model"], items, Precision("f32"))
    low = ref.served_logits(s.params, cell.config["model"], items, Precision("fp8"))
    name = next(k for k in ("widest_gap", "mean_gap") if k in cell.limits)
    prog = check.gap_numbers([gaps(a, torch.as_tensor(it["served"], device=a.device))
                              for a, it in zip(f32, items)])[name]
    ctrl = check.gap_numbers([gaps(a, b.argmax(-1)) for a, b in zip(f32, low)])[name]
    return prog, ctrl, cell.limits[name]


@pytest.mark.parametrize("workload", ["qwen_tiny.video_qa_tiny", "aria_tiny.longdoc_tiny"])
def test_control_fails_the_tiny_limit(tmp_path, workload):
    bench = tiny.make(tmp_path)
    for seed in (1, 2, 3):
        prog, ctrl, limit = readings(bench, workload, seed, 1.0, torch.device("cpu"))
        assert prog <= limit < ctrl, (seed, prog, ctrl, limit)


def test_fp8_rounding():
    from reference.common import fp8_round

    x = torch.tensor([[1.0, 0.1, -448.0, 3.3]])
    y = fp8_round(x, -1)
    assert y[0, 2] == -448.0 and y[0, 0] == 1.0
    assert 0 < abs(float(y[0, 3]) - 3.3) <= 3.3 / 8
    assert not np.allclose(y.numpy(), x.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", REAL)
def test_control_fails_each_cells_limit_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (11, 12, 13):
        prog, ctrl, limit = readings(BENCH, workload, seed, 10.0,
                                               torch.device("cuda", 0))
        assert prog <= limit < ctrl, (seed, prog, ctrl, limit)
        torch.cuda.empty_cache()
