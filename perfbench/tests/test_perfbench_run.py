"""Each driver end to end on the CPU at tiny sizes: the result line, the
check passing on the sound path and failing on each fault the serving cells
can have, no JAX loaded, and the refusals (no card; a checkout without the
port)."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(BENCH / "tests")]

import tiny  # noqa: E402

CELLS = ["qwen_tiny.video_qa_tiny", "aria_tiny.longdoc_tiny"]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def load_run(bench):
    s = importlib.util.spec_from_file_location("pb_run_test", bench / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    return run


def last_line(bench, workload, trace=0, seed=2 ** 31 + 11):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = load_run(bench).main(["--workload", workload, "--seed", str(seed),
                                   "--seconds", "1.5", "--trace", str(trace)],
                                  device_kind="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_prints_the_result_line(bench, workload, trace):
    line = last_line(bench, workload, trace)
    want = KEYS | {"checks"} | ({"breakdown"} if trace else set())
    assert set(line) == want and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        assert names and not {"setup_s", "ttft_p90_ms", "requests_per_s"} & names
    else:
        assert "setup_s" in names and len(names) == 2
    assert line["device"]["count"] == 1


def alter_token(batcher_mod):
    real = batcher_mod.sample_logits

    def wrong(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]

    return "sample_logits", wrong


def freeze_rings(batcher_mod):
    """A decode step that returns its state unchanged: the step's keys and
    values never stay in the ring."""
    real = batcher_mod.ragged_decode_step

    def frozen(layers, model, cfg, cur, pos3, caches, *a, **k):
        saved = [(e[2].clone(), e[3].clone()) for e in caches]
        out = real(layers, model, cfg, cur, pos3, caches, *a, **k)
        for e, (tk, tv) in zip(caches, saved):
            e[2].copy_(tk)
            e[3].copy_(tv)
        return out

    return "ragged_decode_step", frozen


def half_the_wave(batcher_mod):
    """Half of a wave's prompts prefilled, the rest given their results."""
    real = batcher_mod.lm_forward

    def half(params, cfg, *, input_embeds, position_ids, kv_mask, cache, **k):
        B = input_embeds.shape[0]
        h = max(1, B // 2)
        idx = torch.arange(B) % h
        logits, c = real(params, cfg, input_embeds=input_embeds[:h],
                         position_ids=position_ids[:, :h], kv_mask=kv_mask[:h],
                         cache={n: [t[:h] for t in v] for n, v in cache.items()}, **k)
        for n, v in cache.items():
            for full, part in zip(v, c[n]):
                full.copy_(part[idx])
        return logits[idx], cache

    return "lm_forward", half


@pytest.mark.parametrize("fault", [alter_token, freeze_rings, half_the_wave])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(bench, workload, fault, monkeypatch):
    import spacer_tpu_torch.serving.batcher as batcher_mod

    name, broken = fault(batcher_mod)
    monkeypatch.setattr(batcher_mod, name, broken)
    line = last_line(bench, workload, seed=77)
    assert line["correct"] is False, line["checks"]


def test_no_card_no_result(bench, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = load_run(bench).main(["--workload", CELLS[1], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(bench, tmp_path):
    import shutil

    shutil.copytree(bench, tmp_path / "perfbench")
    shutil.copy(bench.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, 'perfbench'); import run; "
            f"sys.exit(run.main(['--workload', '{CELLS[1]}', '--seed', '1', "
            "'--seconds', '1'], device_kind='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_nothing_loads_jax(bench):
    """The harness's modules, every module of the port and a whole tiny run,
    with jax, jaxlib, flax and spacer_tpu blocked: nothing asks for them, and
    no loaded module has their top-level names, compared whole."""
    code = f"""
import importlib, pkgutil, sys, contextlib, io
for name in ("jax", "jaxlib", "flax", "spacer_tpu"):
    sys.modules[name] = None
sys.path[:0] = [{str(bench)!r}, {str(bench.parent)!r}, {str(BENCH.parent)!r}]
import spacer_tpu_torch
for m in pkgutil.walk_packages(spacer_tpu_torch.__path__, "spacer_tpu_torch."):
    importlib.import_module(m.name)
import run, calibrate
for pkg in ("harness", "counts", "reference"):
    p = importlib.import_module(pkg)
    for m in pkgutil.iter_modules(p.__path__, pkg + "."):
        importlib.import_module(m.name)
with contextlib.redirect_stdout(io.StringIO()):
    assert run.main(["--workload", {CELLS[0]!r}, "--seed", "5", "--seconds", "1"],
                    device_kind="cpu") == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "spacer_tpu")
       and sys.modules[m] is not None]
assert not bad and run.forbidden_modules() == [], bad
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
