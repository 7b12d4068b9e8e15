"""The eval harness of spacer_tpu_torch against spacer_tpu's on the same
inputs, at tiny size on the CPU.

- All six benchmarks through EchoEngine (canned answers): the merged jsonl
  records and the metrics must be EQUAL to the JAX package's (the worker,
  prompt and scorer modules are copies; equality shows the copies and the
  port's frame loader behave alike).
- load_video_frames and its reference quirks, the scorer goldens and the
  text tasks, against the JAX package's functions.
- A tiny real QwenEngine in f32 at temperature 0 (weights from
  params_from_jax) on video (LongVideoBench) and one- and two-image
  (SPAR-Bench) rows: static and continuous answers IDENTICAL to the JAX
  package's QwenEngine(attn_impl="xla") (both f32, summation order only,
  far below the logit gaps of a random tiny model's argmax); batch 4 equal
  to batch 1 and to the continuous batcher.
"""

import io
import json
import math
import os

import numpy as np
import pandas as pd
import pytest

import jax
import jax.numpy as jnp

from spacer_tpu.data import MockTokenizer as JaxTokenizer
from spacer_tpu.data import VLProcessor as JaxProcessor
from spacer_tpu.evalharness import EchoEngine as JaxEcho
from spacer_tpu.evalharness import EvalConfig as JaxEvalConfig
from spacer_tpu.evalharness import QwenEngine as JaxEngine
from spacer_tpu.evalharness import run_benchmark as jax_run_benchmark
from spacer_tpu.evalharness import text_tasks as jax_text_tasks
from spacer_tpu.evalharness.util import load_video_frames as jax_load_frames
from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl import tiny_config
from spacer_tpu_torch.data import MockTokenizer, VLProcessor
from spacer_tpu_torch.evalharness import (
    EchoEngine,
    EvalConfig,
    QwenEngine,
    load_video_frames,
    run_benchmark,
)
from spacer_tpu_torch.evalharness import text_tasks
from spacer_tpu_torch.evalharness.benchmarks import (
    longvideobench,
    sparbench,
    stibench,
    tempcompass,
    videomme,
    vsibench,
)
from spacer_tpu_torch.evalharness.util import read_jsonl, write_jsonl
from spacer_tpu_torch.models.qwen25_vl import params_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "eval_scorers_golden.json")


def _video(path, w, h, n, fps, seed=0):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    base = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    for t in range(n):
        writer.write(np.roll(base, t, axis=0))
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """scannet/scene{1,2}.mp4 (3 s, 640x480) and v1 / v2 (2 s, 320x240)."""
    root = tmp_path_factory.mktemp("eval_videos")
    (root / "scannet").mkdir()
    for i, name in enumerate(["scene1", "scene2"]):
        _video(root / "scannet" / f"{name}.mp4", 640, 480, 90, 30.0, seed=i)
        _video(root / f"v{i + 1}.mp4", 320, 240, 60, 30.0, seed=i)
    return root


def _png_bytes(seed, size=56):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (size, size, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _vsi(tmp_path, video_dir):
    rows = [{"id": i, "dataset": "scannet", "scene_name": scene,
             "question": f"q{i}",
             "options": ["A. x", "B. y"] if qt in ("object_rel_distance",
                                                  "route_planning") else [],
             "ground_truth": gt, "question_type": qt}
            for i, (scene, qt, gt) in enumerate([
                ("scene1", "object_counting", "3"),
                ("scene1", "object_rel_distance", "A"),
                ("scene2", "route_planning", "B"),
                ("scene2", "room_size_estimation", "12.5")])]
    pq = tmp_path / "vsi.parquet"
    pd.DataFrame(rows).to_parquet(pq)

    def responder(messages):
        text = messages[0]["content"][-1]["text"]
        for q, a in (("q0", "<think>t</think><answer>three</answer>"),
                     ("q1", "<answer>A</answer>"), ("q2", "<answer>C</answer>")):
            if q in text:
                return a
        return "<answer>12 square meters</answer>"

    return (dict(data_file=str(pq), video_dir=str(video_dir), world_size=2,
                 num_frames=4), responder)


def _sti(tmp_path, video_dir):
    rows = [{"ID": 1, "Video": "v1.mp4", "Task": "Spatial Relation",
             "Question": "Left or right?",
             "Candidates": {"A": "left", "B": "right"},
             "time_start": 0, "time_end": 2, "Answer": "A"},
            {"ID": 2, "Video": "v2.mp4", "Task": "Speed & Acceleration",
             "Question": "Fast?", "Candidates": {"A": "yes", "B": "no"},
             "time_start": 1, "time_end": 2, "Answer": "B"}]
    pq = tmp_path / "sti.parquet"
    pd.DataFrame(rows).to_parquet(pq)
    return (dict(data_file=str(pq), video_dir=str(video_dir), num_frames=4),
            lambda m: "<think>t</think><answer>(A)</answer>")


def _spar(tmp_path, video_dir):
    rows = [{"id": 1, "task": "depth_prediction_oc", "question": "How deep?",
             "answer": "3.5", "img_type": "single",
             "image": [{"bytes": _png_bytes(0)}]},
            {"id": 2, "task": "obj_spatial_relation_oo", "question": "Where?",
             "answer": "A", "img_type": "multi",
             "image": [{"bytes": _png_bytes(1)}, {"bytes": _png_bytes(2)}]}]
    pq = tmp_path / "spar0.parquet"
    pd.DataFrame(rows).to_parquet(pq)

    def responder(messages):
        if "How deep" in messages[0]["content"][-1]["text"]:
            return "<answer>3.4 meters</answer>"
        return "<answer>A</answer>"

    return dict(data_file=[str(pq)], video_dir="."), responder


def _videomme(tmp_path, video_dir):
    rows = [{"question_id": f"q{i}", "videoID": "v1", "question": q,
             "options": ["A. x", "B. y"], "answer": a, "task_type": "Temporal",
             "duration": "short"}
            for i, (q, a) in enumerate([("Which?", "A"), ("Which now?", "B")])]
    pq = tmp_path / "vmme.parquet"
    pd.DataFrame(rows).to_parquet(pq)
    return (dict(data_file=str(pq), video_dir=str(video_dir), num_frames=4),
            lambda m: "<answer>The correct answer is A</answer>")


def _lvb(tmp_path, video_dir):
    rows = [{"id": 1, "video_id": "v1", "question": "What happened?",
             "candidates": ["first", "second", "third"], "correct_choice": 1,
             "question_category": "S2E", "topic_category": "t",
             "duration": 2.0},
            {"id": 2, "video_id": "v2", "question": "Then?",
             "candidates": ["x", "y"], "correct_choice": 0,
             "question_category": "E3E", "topic_category": "t",
             "duration": 2.0}]
    data = tmp_path / "lvb.json"
    data.write_text(json.dumps(rows))
    return (dict(data_file=str(data), video_dir=str(video_dir), num_frames=4),
            lambda m: "<answer>B</answer>")


def _tempcompass(tmp_path, video_dir):
    rows = [{"video_id": "v1", "problem_type": "multiple choice",
             "problem": "Which color?", "options": ["A. red", "B. blue"],
             "solution": "<answer>A. red</answer>"},
            {"video_id": "v2", "problem_type": "multiple choice",
             "problem": "Which shape?", "options": ["A. square", "B. round"],
             "solution": "<answer>B. round</answer>"}]
    data = tmp_path / "tc.json"
    data.write_text(json.dumps(rows))
    return (dict(data_file=str(data), video_dir=str(video_dir), num_frames=4,
                 fps=1), lambda m: "<answer>A</answer>")


CASES = {"VSI-Bench": _vsi, "STI-Bench": _sti, "SPAR-Bench": _spar,
         "Video-MME": _videomme, "LongVideoBench": _lvb,
         "TempCompass": _tempcompass}


def _assert_equal(ours, ref, path=""):
    """Exact equality of nested results; NaN equals NaN."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), (path, ours)
        for k in ref:
            _assert_equal(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_equal(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) and math.isnan(ref):
        assert isinstance(ours, float) and math.isnan(ours), (path, ours)
    else:
        assert ours == ref, (path, ours, ref)


@pytest.mark.parametrize("task", sorted(CASES))
def test_benchmark_matches_jax_through_echo_engine(task, video_dir, tmp_path):
    kw, responder = CASES[task](tmp_path, video_dir)
    out = {}
    for side, cfg_cls, engine, run in (
            ("jax", JaxEvalConfig, JaxEcho(responder), jax_run_benchmark),
            ("torch", EvalConfig, EchoEngine(responder), run_benchmark)):
        out_dir = tmp_path / side
        metrics = run(cfg_cls(task=task, output_dir=str(out_dir),
                              prompt_type="thinking", **kw), engine)
        docs = read_jsonl(str(out_dir / f"{task}_results.jsonl"))
        out[side] = (metrics, docs, engine.calls)
    metrics, docs, calls = out["torch"]
    assert docs and calls
    _assert_equal(metrics, out["jax"][0])
    _assert_equal(docs, out["jax"][1])
    assert calls == out["jax"][2]


@pytest.mark.parametrize("size,nframes,fps", [((640, 480), 8, 1),
                                              ((640, 360), 32, 1),
                                              ((320, 240), 4, 0)])
def test_load_video_frames_matches_jax(tmp_path, size, nframes, fps):
    """Same frames, timestamps and duration as the JAX loader, including the
    reference's aspect transposition: a 640x480 frame comes out 336 wide
    and 448 high, a 640x360 one 251 x 448 (int(360 * (448 / 640)) truncates
    251.99999999999997)."""
    w, h = size
    path = _video(tmp_path / "v.mp4", w, h, 90, 30.0)
    got = load_video_frames(path, nframes, fps, (448, 448))
    ref = jax_load_frames(path, nframes, fps, (448, 448))
    assert got[1:] == ref[1:]
    assert len(got[0]) == len(ref[0]) == (3 if fps else nframes)
    for a, b in zip(got[0], ref[0]):
        assert a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    expect = {(640, 480): (336, 448), (640, 360): (251, 448),
              (320, 240): (320, 240)}[size]
    assert got[0][0].size == expect
    assert load_video_frames(str(tmp_path / "missing.mp4")) == (None,) * 3


SCORERS = {"vsibench": vsibench.vsibench_eval,
           "stibench": stibench.stibench_eval,
           "sparbench": sparbench.sparbench_eval,
           "videomme": videomme.videomme_eval,
           "longvideobench": longvideobench.longvideobench_eval,
           "tempcompass": tempcompass.tempcompass_eval}


@pytest.mark.parametrize("name", sorted(SCORERS))
def test_scorer_golden(name, tmp_path):
    """The reference scorers' outputs on recorded docs (the golden file the
    JAX package's tests use), to 1e-9."""
    with open(GOLDEN) as f:
        case = json.load(f)[name]
    jsonl = tmp_path / f"{name}.jsonl"
    write_jsonl(str(jsonl), case["docs"])
    ours = SCORERS[name](str(jsonl), "thinking")

    def close(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), path
        elif isinstance(b, (int, float)):
            assert a == pytest.approx(b, abs=1e-9), (path, a, b)
        else:
            assert a == b, path

    close(ours, case["out"], name)


def test_text_tasks_match_jax():
    texts = [r"so the answer is \boxed{42}", r"\boxed{1} no \boxed{\frac{3}{4}}",
             "the result is 3.14 exactly", "no numbers", r"... \boxed{0.75}",
             "answer 41", r"\boxed{1,000}", ""]
    golds = ["42", r"\boxed{3/4}", "3.14", "1", r"\boxed{3/4}", "42", "1000",
             "42"]
    for t, g in zip(texts, golds):
        assert text_tasks.extract_boxed(t) == jax_text_tasks.extract_boxed(t)
        assert (text_tasks.math_answer_match(t, g)
                == jax_text_tasks.math_answer_match(t, g))
    assert text_tasks.math_answer_match(r"... \boxed{0.75}", r"\boxed{3/4}") == 1.0
    assert [t.name for t in text_tasks.TASKS_TABLE] == ["aime24", "math_500"]
    rows = [{"problem": "1+1?", "solution": r"\boxed{2}"},
            {"problem": "2*3?", "solution": r"\boxed{6}"},
            {"problem": "5-1?", "solution": r"\boxed{4}"}]
    table = {"1+1?": r"\boxed{2}", "2*3?": r"\boxed{7}", "5-1?": "the answer is 4"}

    def generate(prompts):
        return [table[p] for p in prompts]

    out = text_tasks.evaluate_text_task(text_tasks.AIME24, rows, generate, 2)
    assert out == jax_text_tasks.evaluate_text_task(jax_text_tasks.AIME24,
                                                    rows, generate, 2)
    assert out["n"] == 3 and abs(out["accuracy"] - 2 / 3) < 1e-9


@pytest.fixture(scope="module")
def tiny_model():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(0), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def _real_run(side, tiny_model, task, data_kw, out_dir, **cfg_kw):
    cfg, jparams, tparams = tiny_model
    if side == "jax":
        engine = JaxEngine(cfg, jparams, JaxProcessor(
            JaxTokenizer(vocab_size=cfg.text.vocab_size), cfg),
            attn_impl="xla", length_bucket=64)
        ecfg, run = JaxEvalConfig, jax_run_benchmark
    else:
        engine = QwenEngine(cfg, tparams, VLProcessor(
            MockTokenizer(vocab_size=cfg.text.vocab_size), cfg),
            length_bucket=64)
        ecfg, run = EvalConfig, run_benchmark
    metrics = run(ecfg(task=task, output_dir=str(out_dir),
                       prompt_type="thinking", temperature=0.0,
                       max_new_tokens=8, **data_kw, **cfg_kw), engine)
    docs = read_jsonl(str(out_dir / f"{task}_results.jsonl"))
    return metrics, {d["id"]: d["predicted_answer"] for d in docs}, engine


@pytest.fixture(scope="module")
def real_data(tmp_path_factory):
    """4 LongVideoBench rows over two 2 s 64x48 videos, and 3 SPAR-Bench
    rows of one and two 56x56 PNG images (base64 data URIs)."""
    d = tmp_path_factory.mktemp("real_data")
    for i in range(2):
        _video(d / f"v{i + 1}.mp4", 64, 48, 16, 8.0, seed=i)
    rows = [{"id": i, "video_id": f"v{i % 2 + 1}", "question": q,
             "candidates": c, "correct_choice": 0, "question_category": "S2E",
             "topic_category": "t", "duration": 2.0}
            for i, (q, c) in enumerate([
                ("What happened?", ["first", "second", "third"]),
                ("Then what?", ["x", "y"]),
                ("Which object moved first in the clip?", ["a", "b", "c", "d"]),
                ("Why?", ["p", "q"])])]
    (d / "lvb.json").write_text(json.dumps(rows))
    spar = [{"id": 1, "task": "depth_prediction_oc", "question": "How deep?",
             "answer": "3.5", "img_type": "single",
             "image": [{"bytes": _png_bytes(0)}]},
            {"id": 2, "task": "obj_spatial_relation_oo", "question": "Where?",
             "answer": "A", "img_type": "multi",
             "image": [{"bytes": _png_bytes(1)}, {"bytes": _png_bytes(2)}]},
            {"id": 3, "task": "view_change_infer", "question": "Actions?",
             "answer": "move_right:1,move_up:0", "img_type": "multi",
             "image": [{"bytes": _png_bytes(3)}, {"bytes": _png_bytes(4)}]}]
    pd.DataFrame(spar).to_parquet(d / "spar.parquet")
    return {"LongVideoBench": dict(data_file=str(d / "lvb.json"),
                                   video_dir=str(d), num_frames=4),
            "SPAR-Bench": dict(data_file=[str(d / "spar.parquet")],
                               video_dir=".")}


@pytest.mark.parametrize("serving", ["static", "continuous"])
@pytest.mark.parametrize("task", ["LongVideoBench", "SPAR-Bench"])
def test_real_engine_greedy_answers_match_jax(task, serving, tiny_model,
                                              real_data, tmp_path):
    """Video rows and mixed one- and two-image rows, batches of 2."""
    got = _real_run("torch", tiny_model, task, real_data[task],
                    tmp_path / "torch", batch_size=2, serving=serving)
    ref = _real_run("jax", tiny_model, task, real_data[task], tmp_path / "jax",
                    batch_size=2, serving=serving)
    assert len(got[1]) == (4 if task == "LongVideoBench" else 3)
    assert got[1] == ref[1]
    _assert_equal(got[0], ref[0])


def test_real_engine_batching_keeps_the_answers(tiny_model, real_data,
                                                tmp_path):
    """Static batches of 4 prompts (one Sampler.generate, rows of different
    lengths left-padded) answer as batches of 1 do, and as the continuous
    batcher does."""
    preds = {}
    for name, kw in (("b1", dict(batch_size=1)), ("b4", dict(batch_size=4)),
                     ("cont", dict(batch_size=2, serving="continuous"))):
        _, preds[name], engine = _real_run(
            "torch", tiny_model, "LongVideoBench", real_data["LongVideoBench"],
            tmp_path / name, **kw)
        if name != "cont":
            assert engine._calls == 4 // kw["batch_size"]
    assert len(preds["b1"]) == 4
    assert preds["b1"] == preds["b4"] == preds["cont"]
