"""The port's SG-RLVR training entry point on the CPU: a jsonl dataset of two
rows over a real mp4 (one SR_dataset row with a cognitive map, one
multiple-choice row), a tiny random model, one optimizer step, metrics and
the final checkpoint written, with bf16 and int8_kv rollouts; an unknown
decode_quant refused; no CPU run without `--device cpu`.  The eval entry
point over a LongVideoBench JSON file prints the benchmark's metrics, and
runs speculative decoding with continuous serving only."""

import dataclasses
import json
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_cli_data")
    vid = root / "clip.mp4"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (128, 96))
    base = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    for t in range(60):
        w.write(np.roll(base, 2 * t, axis=1))
    w.release()
    rows = [
        {"problem": "How many chairs?", "problem_type": "numerical",
         "solution": "<answer>3</answer>", "path": str(vid),
         "data_type": "video", "data_source": "SR_dataset", "problem_id": 0},
        {"problem": "Pick one.", "problem_type": "multiple choice",
         "options": ["A. x", "B. y"], "solution": "<answer>A</answer>",
         "path": str(vid), "data_type": "video", "data_source": "other",
         "problem_id": 1},
    ]
    with open(root / "train.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with open(root / "cogmap.jsonl", "w") as f:
        f.write(json.dumps({
            "video_id": "clip",
            "cognitive_map": {"chair": [[1, 2]], "table": [[7, 7]]},
            "object_list": ["chair", "table"]}) + "\n")
    return root


def _argv(data_dir, out, quant, device=("--device", "cpu")):
    return ["--dataset_name", str(data_dir / "train.jsonl"),
            "--cognitive_map_path", str(data_dir / "cogmap.jsonl"),
            "--random_init", "true", "--dtype", "float32",
            "--output_dir", str(out), "--max_steps", "1",
            "--num_generations", "2", "--max_prompt_length", "512",
            "--max_completion_length", "4", "--prompt_bucket", "64",
            "--logp_chunk", "4", "--decode_quant", quant, *device]


def _one_step(data_dir, out, quant):
    from spacer_tpu_torch.cli.train_sg_rlvr import main

    main(_argv(data_dir, out, quant))
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
    assert "rewards/accuracy_reward" in recs[0]
    assert os.path.exists(out / "final" / "params.pt")


def test_train_sg_rlvr_cli_one_step(data_dir, tmp_path, capsys):
    _one_step(data_dir, tmp_path / "out", "none")
    assert "rollout decode quantized" not in capsys.readouterr().out


def test_train_sg_rlvr_cli_int8_kv_one_step(data_dir, tmp_path, capsys):
    """The trainer's default rollouts (int8 weights and KV) from the CLI,
    with the JAX trainer's notice."""
    _one_step(data_dir, tmp_path / "out", "int8_kv")
    assert ("rollout decode quantized: decode_quant='int8_kv'"
            in capsys.readouterr().out)


def test_train_sg_rlvr_cli_refuses_quantised_rollouts(data_dir, tmp_path):
    """Only the decode_quant values the JAX package knows are accepted."""
    from spacer_tpu_torch.cli.train_sg_rlvr import main

    with pytest.raises(ValueError, match="decode_quant"):
        main(_argv(data_dir, tmp_path / "out", "int2"))


def test_train_sg_rlvr_cli_needs_cuda_or_device_cpu(data_dir, tmp_path,
                                                     monkeypatch):
    """The CLI runs on the card by default; where CUDA is absent it raises
    instead of carrying on on the CPU."""
    import torch

    from spacer_tpu_torch.cli.train_sg_rlvr import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(_argv(data_dir, tmp_path / "out", "none", device=()))


def _lvb_argv(data_dir, out, *extra):
    rows = [{"id": i, "video_id": "clip", "question": q, "candidates": c,
             "correct_choice": 0, "question_category": "S2E",
             "topic_category": "t", "duration": 2.0}
            for i, (q, c) in enumerate([("What moves?", ["a", "b"]),
                                        ("Where to?", ["left", "right", "up"])])]
    data = out.parent / "lvb.json"
    data.write_text(json.dumps(rows))
    return ["--task", "LongVideoBench", "--data_file", str(data),
            "--video_dir", str(data_dir), "--output_dir", str(out),
            "--num_frames", "4", "--max_new_tokens", "4", "--batch_size", "2",
            "--random_init", "true", "--dtype", "float32", *extra]


def test_evaluate_cli_prints_the_metrics(data_dir, tmp_path):
    """`python -m spacer_tpu_torch.cli.evaluate` on a LongVideoBench JSON
    file: both rows written and scored, the metrics printed as JSON."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "spacer_tpu_torch.cli.evaluate",
         *_lvb_argv(data_dir, out, "--device", "cpu")],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    metrics = json.loads(res.stdout[res.stdout.index("{"):])
    assert {"overall_accuracy", "all_duration_tasks", "perception_task_accuracy",
            "relation_task_accuracy"} <= set(metrics)
    docs = [json.loads(line)
            for line in open(out / "LongVideoBench_results.jsonl")]
    assert [d["id"] for d in docs] == [0, 1]


def test_evaluate_cli_refuses_speculation(data_dir, tmp_path, monkeypatch):
    """--speculate_k with --serving static (the default) is refused with
    SystemExit before any model is built; with --serving continuous it runs
    the benchmark through speculating batchers."""
    import spacer_tpu_torch.cli.evaluate as evaluate

    load = evaluate.load_model_and_processor

    def no_load(args):
        raise AssertionError("the model was loaded before the refusal")

    monkeypatch.setattr(evaluate, "load_model_and_processor", no_load)
    with pytest.raises(SystemExit, match="continuous"):
        evaluate.main(_lvb_argv(data_dir, tmp_path / "out", "--device", "cpu",
                                "--speculate_k", "2"))
    monkeypatch.setattr(evaluate, "load_model_and_processor", load)
    out = tmp_path / "spec"
    metrics = evaluate.main(_lvb_argv(data_dir, out, "--device", "cpu",
                                      "--serving", "continuous",
                                      "--speculate_k", "2"))
    assert "overall_accuracy" in metrics
    docs = [json.loads(line)
            for line in open(out / "LongVideoBench_results.jsonl")]
    assert [d["id"] for d in docs] == [0, 1]


def test_train_grpo_cli_one_step(data_dir, tmp_path):
    """The plain video-GRPO entry point: one step, its two rewards logged,
    the final checkpoint written; remat given by name."""
    from spacer_tpu_torch.cli.train_grpo import main

    out = tmp_path / "grpo"
    argv = [a for a in _argv(data_dir, out, "none")
            if a not in ("--cognitive_map_path",
                         str(data_dir / "cogmap.jsonl"))]
    main(argv + ["--remat", "dots_narrow"])
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
    assert "rewards/grpo_accuracy_reward" in recs[0]
    assert "rewards/format_reward" in recs[0]
    assert os.path.exists(out / "final" / "params.pt")


@pytest.mark.parametrize("qtype,solution", [
    ("multiple choice", "<answer>B</answer>"),
    ("numerical", "<answer>3</answer>"),
    ("regression", "<answer>3.2</answer>"),
    ("OCR", "<answer>exit</answer>"),
    ("free-form", "<answer>a red chair</answer>")])
def test_grpo_accuracy_reward_equals_jax(qtype, solution):
    from spacer_tpu.cli.train_grpo import grpo_accuracy_reward as jax_reward
    from spacer_tpu_torch.cli.train_grpo import grpo_accuracy_reward

    texts = ["<think>x</think><answer>B</answer>", "<answer>3.5</answer>",
             "<answer>3</answer>", "<answer>exit</answer>", "no tags",
             "<answer>a red chair</answer>"]
    comps = [[{"content": t}] for t in texts]
    n = len(comps)
    kw = dict(problem_type=[qtype] * n, data_source=["x"] * n,
              map_data={"unused": 1})
    ours = grpo_accuracy_reward(comps, [solution] * n, **dict(kw))
    theirs = jax_reward(comps, [solution] * n, **dict(kw))
    assert ours == theirs and len(ours) == n
    if qtype in ("multiple choice", "numerical"):
        assert max(ours) > 0
    else:
        assert ours == [0.0] * n


def test_serve_cli_aria_text(tmp_path):
    """`serve --model_family aria --random_init true`: the tiny random Aria
    model serves text rows through the continuous batcher."""
    from spacer_tpu_torch.cli.serve import main

    inp, out = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    inp.write_text("".join(json.dumps({"prompt": p}) + "\n"
                           for p in ("count the chairs", "what is here")))
    main(["--model_family", "aria", "--random_init", "true", "--dtype",
          "float32", "--device", "cpu", "--input_file", str(inp),
          "--output_file", str(out), "--max_new_tokens", "4", "--slots", "2"])
    rows = [json.loads(line) for line in open(out)]
    assert [r["prompt"] for r in rows] == ["count the chairs", "what is here"]
    assert all(isinstance(r["completion"], str) for r in rows)


def test_train_grpo_cli_aria_image_step(tmp_path, monkeypatch):
    """`train_grpo --model_family aria --random_init true` on an image row:
    one step through the tiny Aria tower, projector and MoE LM.  The
    family's processor is the reference's, whose 490 / 980-pixel crops
    hand tiny_aria_config's 56-pixel tower a patch count its projector has
    no queries for (ROADMAP queue C), so the test gives it crops of the
    tower's size, as the parity tests do."""
    from PIL import Image

    from spacer_tpu_torch.cli.train_grpo import main
    from spacer_tpu_torch.data.aria_processor import AriaProcessor
    from spacer_tpu_torch.models import registry

    family = registry.get_family("aria")
    monkeypatch.setitem(registry._CACHE, "aria", dataclasses.replace(
        family, make_processor=lambda tok, cfg, device="cpu": AriaProcessor(
            tok, cfg, max_image_size=56, min_image_size=14,
            size_conversion={56: 8})))

    img = tmp_path / "scene.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (120, 160, 3), np.uint8)).save(img)
    data = tmp_path / "train.jsonl"
    data.write_text(json.dumps({
        "problem": "How many chairs?", "problem_type": "numerical",
        "solution": "<answer>3</answer>", "path": str(img),
        "data_type": "image", "data_source": "other", "problem_id": 0}) + "\n")
    out = tmp_path / "grpo"
    main(["--dataset_name", str(data), "--model_family", "aria",
          "--random_init", "true", "--dtype", "float32", "--device", "cpu",
          "--output_dir", str(out), "--max_steps", "1", "--num_generations",
          "2", "--max_completion_length", "4", "--prompt_bucket", "64",
          "--logp_chunk", "4", "--decode_quant", "none"])
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
    assert "rewards/grpo_accuracy_reward" in recs[0]
    assert os.path.exists(out / "final" / "params.pt")
