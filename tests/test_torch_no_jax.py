"""spacer_tpu_torch stands alone: no module of it (nor the scripts that
drive it on the card, chip_smoke.py, profile_train.py and profile_serve.py)
imports jax or spacer_tpu, and the tiny serving slice and one tiny SG-RLVR
training step run on the CPU through the kernels' plain versions (no
kernel launch is counted there); a checkpoint round trip needs neither the
safetensors nor the transformers package, and the eval harness runs a
benchmark there."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "spacer_tpu_torch"

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "spacer_tpu"):
        sys.modules[name] = None          # any import of these now fails
    import numpy as np
    import spacer_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        spacer_tpu_torch.__path__, "spacer_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from spacer_tpu_torch.cli.common import ModelArgs, load_model_and_processor
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, params, proc = load_model_and_processor(
        ModelArgs(random_init=True, dtype="float32", device="cpu"))
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    msgs = [[{"role": "user", "content": [
                {"type": "video", "video": frames, "fps": 2.0},
                {"type": "text", "text": "what moves"}]}],
            [{"role": "user", "content": "hello"}]]
    reset_launch_counts()
    texts = QwenEngine(cfg, params, proc, length_bucket=64).generate_many(
        msgs, max_new_tokens=4, temperature=0.0, slots=2)
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    assert set(launch_counts().values()) == {0}, launch_counts()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("imported", len(names), "modules")
""")


TRAIN_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    for name in ("jax", "jaxlib", "spacer_tpu"):
        sys.modules[name] = None
    import numpy as np
    from spacer_tpu_torch.cli.common import ModelArgs, load_model_and_processor
    from spacer_tpu_torch.data import make_conversation
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.rewards import format_reward
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer
    cfg, params, proc = load_model_and_processor(
        ModelArgs(random_init=True, dtype="float32", device="cpu"))
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    row = {"problem": "how many", "problem_type": "numerical",
           "solution": "<answer>1</answer>", "path": frames,
           "data_type": "video", "data_source": "synthetic"}
    row.update(make_conversation(row))
    args = SGRLVRConfig(num_generations=2, max_completion_length=4,
                        prompt_bucket=64, logp_chunk=4, decode_quant=None,
                        output_dir=tempfile.mkdtemp())
    reset_launch_counts()
    trainer = SGRLVRTrainer(cfg, params, proc, [format_reward], [row], args)
    m = trainer.training_step([row], np.random.default_rng(0))
    assert np.isfinite(float(m["loss"])), m
    assert set(launch_counts().values()) == {0}, launch_counts()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("trained")
""")


EVAL_SCRIPT = textwrap.dedent("""
    import json, os, sys, tempfile
    for name in ("jax", "jaxlib", "spacer_tpu", "safetensors", "transformers"):
        sys.modules[name] = None
    import cv2
    import numpy as np
    import torch
    from spacer_tpu_torch.evalharness import EchoEngine, EvalConfig, run_benchmark
    from spacer_tpu_torch.models.qwen25_vl import (
        export_to_safetensors, init_params, load_params_from_hf, tiny_config)
    d = tempfile.mkdtemp()
    cfg = tiny_config()
    params = init_params(cfg, dtype=torch.bfloat16)
    export_to_safetensors(params, cfg, os.path.join(d, "ckpt"),
                          max_shard_bytes=100_000)
    loaded, _ = load_params_from_hf(os.path.join(d, "ckpt"), device="cpu")
    assert torch.equal(loaded["model"]["lm_head"]["kernel"],
                       params["model"]["lm_head"]["kernel"])
    w = cv2.VideoWriter(os.path.join(d, "v1.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (64, 48))
    for t in range(16):
        w.write(np.full((48, 64, 3), 8 * t, np.uint8))
    w.release()
    rows = [{"id": 1, "video_id": "v1", "question": "What happened?",
             "candidates": ["first", "second"], "correct_choice": 1,
             "question_category": "S2E", "topic_category": "t",
             "duration": 2.0}]
    with open(os.path.join(d, "lvb.json"), "w") as f:
        json.dump(rows, f)
    metrics = run_benchmark(EvalConfig(
        task="LongVideoBench", data_file=os.path.join(d, "lvb.json"),
        video_dir=d, output_dir=os.path.join(d, "out"), num_frames=4),
        EchoEngine(lambda m: "<answer>B</answer>"))
    assert metrics["overall_accuracy"] == 1.0, metrics
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu", "safetensors",
                                  "transformers")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("evaluated")
""")


def _run(script, marker):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert marker in res.stdout


def test_port_imports_no_jax_and_runs_on_cpu():
    _run(SCRIPT, "imported")


def test_training_step_runs_without_jax_on_cpu():
    _run(TRAIN_SCRIPT, "trained")


def test_checkpoint_and_eval_run_without_jax_safetensors_transformers():
    _run(EVAL_SCRIPT, "evaluated")


def test_no_jax_or_spacer_tpu_import_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|spacer_tpu)(\.|\s|$)",
                         re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py",
               REPO / "profile_train.py", REPO / "profile_serve.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
