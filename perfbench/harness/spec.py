"""Finds every piece of a cell by name, so that a later change adds a
configuration, a traffic mix, a driver or a metric as a new file:

- BENCHMARK.json (the checkout's root): the cells and their metrics;
- configs/<config>.json: the model configuration as it is run;
- traffic/<traffic>.json: one traffic mix's parameters; its "driver" names
  drivers/<driver>.py, whose `run(cell)` serves the mix;
- limits/<workload>.json: the numbers the correctness check holds the
  cell's outputs to;
- metrics/<metric>.py, or metrics/<part before the first dot>.py: a reader
  `read(record) -> float | None` of the run's record.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent.parent


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<workload>.json
    end_to_end: list    # this cell's end-to-end metric entries
    per_layer: list     # this cell's per-layer metric entries
    bench: pathlib.Path

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.bench / "drivers" / f"{name}.py",
                           f"perfbench_driver_{name}")

    def reader(self, metric: str):
        """The metric's `read` function."""
        for stem in (metric, metric.split(".")[0]):
            path = self.bench / "metrics" / f"{stem}.py"
            if path.exists():
                return load_module(path, "perfbench_metric_" + stem.replace(".", "_")).read
        raise FileNotFoundError(f"no reader for metric {metric!r} under "
                                f"{self.bench / 'metrics'}")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, bench: pathlib.Path = BENCH,
            benchmark: dict | None = None) -> Cell:
    """The cell named `workload` of BENCHMARK.json (at bench's parent unless
    given)."""
    if benchmark is None:
        benchmark = load_json(bench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in benchmark["configs"]}
    config = load_json(bench.parent / configs[w["config"]]["file"])
    return Cell(
        workload=w, config=config,
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in benchmark["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in benchmark["per_layer"] if applies(m, workload)],
        bench=bench)
