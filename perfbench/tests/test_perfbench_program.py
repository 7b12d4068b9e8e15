"""The per-layer metrics read from the port's own spans and counters
(harness/program.py, spacer_tpu_torch.utils.profiling): a traced run of
each tiny cell while the port records prints every one its cell names, each
is found by name, and each reads None, without raising, where the port has
no record."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import pathlib
import sys
import types

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import tiny  # noqa: E402
from harness import spec  # noqa: E402

CELLS = ["qwen_tiny.video_qa_tiny", "aria_tiny.longdoc_tiny"]
PROGRAM = ("program_span", "program_counter")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def program_metrics(bench, workload) -> list:
    cell = spec.resolve(workload, bench)
    return [m["name"] for m in cell.per_layer
            if m["source"] in PROGRAM and m["name"].split(".")[0] not in (
                "admit_ms", "pad_share", "decode_step_ms")]


def traced_line(bench, workload) -> dict:
    s = importlib.util.spec_from_file_location("pb_run_program", bench / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(2 ** 31 + 5),
                       "--seconds", "1.5", "--trace", "1"], device_kind="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_prints_each_program_metric(bench, workload):
    """On the card the traced window's torch.profiler session makes the port
    record; the CPU rehearsal runs no profiler, so it records explicitly."""
    from spacer_tpu_torch.utils import profiling

    names = program_metrics(bench, workload)
    assert len(names) == {"qwen_tiny.video_qa_tiny": 10,
                          "aria_tiny.longdoc_tiny": 6}[workload]
    with profiling.recording():
        line = traced_line(bench, workload)
    assert line["correct"] is True, line["checks"]
    for name in names:
        assert name in line["metrics"], (name, sorted(line["metrics"]))
        assert line["metrics"][name]["value"] >= 0, name
    got = {n.split(".")[0]: line["metrics"][n]["value"] for n in names}
    assert got["decode_launch_ms"] > 0 and got["prefill_ms"] > 0
    # the tiny cells' steps read the done flags once each, or once more when
    # a chunk ends early
    assert 1.0 <= got["host_syncs_per_step"] <= 2.0
    assert 0 <= got["program_pad_share"] < 100
    if "slot_occupancy" in got:
        assert 0 < got["slot_occupancy"] <= 100
    if "program_ttft_p90_ms" in got:
        assert 0 < got["program_queue_wait_p90_ms"] < got["program_ttft_p90_ms"]


@pytest.mark.parametrize("workload", CELLS)
def test_each_reader_is_found_and_reads_none_without_a_record(
        bench, workload, monkeypatch):
    from spacer_tpu_torch.utils import profiling

    cell = spec.resolve(workload, bench)
    record = types.SimpleNamespace(trace={}, window=(0.0, 1.0),
                                   serving=cell.traffic["serving"])
    untraced = types.SimpleNamespace(trace=None, window=(0.0, 1.0),
                                     serving=cell.traffic["serving"])
    names = program_metrics(bench, workload)
    for name in names:
        assert cell.reader(name)(untraced) is None
    monkeypatch.delattr(profiling, "last_record")   # a port before the recorder
    for name in names:
        assert cell.reader(name)(record) is None
