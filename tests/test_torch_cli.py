"""The port's SG-RLVR training entry point on the CPU: a jsonl dataset of two
rows over a real mp4 (one SR_dataset row with a cognitive map, one
multiple-choice row), a tiny random model, one optimizer step, metrics and
the final checkpoint written, with bf16 and int8_kv rollouts; an unknown
decode_quant refused; no CPU run without `--device cpu`."""

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
