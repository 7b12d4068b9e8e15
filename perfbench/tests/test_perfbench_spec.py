"""BENCHMARK.json keeps to the benchmark's contract, every cell finds its
files by name, and a new traffic mix and a new metric are taken by adding
files (and entries in BENCHMARK.json) alone."""

from __future__ import annotations

import json
import pathlib
import re
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

from harness import spec  # noqa: E402

REPO = BENCH.parent
DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in DOC["workloads"]]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["perfbench"]
    assert DOC["command"][1] == "perfbench/run.py" and len(DOC["command"]) <= 32
    assert all(one_line(w) for w in DOC["command"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) < 64 * 1024


def test_run_seconds_fit_the_full_check():
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 180 s
    of compile a cell and 1200 s spare, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(DOC["configs"]) <= 24
    used = {w["config"] for w in DOC["workloads"]}
    files = set()
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["why"]) and one_line(c["source"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []


def test_published_numbers_match_what_is_run():
    """The top level of a config file holds the published numbers; the
    harness runs its "model" group. Both have to give the same sizes."""
    for c in DOC["configs"]:
        body = json.loads((REPO / c["file"]).read_text())
        model = body["model"]
        run = {**model, **model.get("text_config", {})}
        run["vision_config"] = model.get("vision_config")
        for k, v in body.items():
            if k in run and k != "model_type":
                assert run[k] == v, (c["name"], k)
        for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "num_key_value_heads", "vocab_size"):
            assert body[k] == run[k], (c["name"], k)

def test_workloads():
    assert 1 <= len(DOC["workloads"]) <= 24
    pairs = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics():
    names = set()
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "source", "bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w)
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
        assert all(w in WORKLOADS for w in m.get("workloads", WORKLOADS))
    for w in WORKLOADS:
        cell_e2e = [m for m in DOC["end_to_end"] if spec.applies(m, w)]
        assert len(cell_e2e) >= 2
        assert any(spec.applies(m, w) for m in DOC["per_layer"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_every_file_by_name(workload):
    cell = spec.resolve(workload, BENCH)
    assert cell.driver().run
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert any(cell.limits.get(k, 0) > 0 for k in ("widest_gap", "mean_gap"))
    assert cell.traffic["driver"] in ("open_loop_serving", "offline_serving")


def test_a_new_traffic_mix_and_metric_are_files(tmp_path):
    """A dummy traffic file, a dummy metric reader and their entries in
    BENCHMARK.json: the harness runs the new cell and reports the metric,
    with no other file edited."""
    import importlib.util

    import tiny

    bench = tiny.make(tmp_path)
    tr = json.loads((bench / "traffic/longdoc_tiny.json").read_text())
    tr["fields"]["prompt_tokens"] = {"kind": "const", "value": 20}
    (bench / "traffic/dummy_mix.json").write_text(json.dumps(tr))
    (bench / "metrics/dummy_count.py").write_text(
        "def read(record):\n    return float(len(record.requests))\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "aria_tiny.dummy_mix", "config": "aria_tiny",
                             "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for m in doc["end_to_end"]:
        if m["name"] == "requests_per_s":
            m["workloads"].append("aria_tiny.dummy_mix")
    doc["per_layer"].append({"name": "dummy_count.rps", "unit": "requests",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving loop", "moves": "requests_per_s",
                             "workloads": ["aria_tiny.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (bench / "limits/aria_tiny.dummy_mix.json").write_text(
        (bench / "limits/aria_tiny.longdoc_tiny.json").read_text())
    s = importlib.util.spec_from_file_location("pb_run_dummy", bench / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    cell = spec.resolve("aria_tiny.dummy_mix", bench)
    record = cell.driver().run(cell, seed=5, seconds=1.0, trace=True,
                               device=__import__("torch").device("cpu"),
                               t_start=0.0)
    metrics = run.metrics_of(cell, record, True)
    assert metrics["dummy_count.rps"]["value"] == len(record.requests) > 0
    assert all(r.prompt_len == 20 for r in record.requests)
