"""spacer_tpu_torch stands alone: no module of it (nor the scripts that
drive it on the card, chip_smoke.py, profile_train.py, profile_serve.py,
profile_tp.py and time_tp_collectives.py)
imports jax or spacer_tpu, and the tiny serving slice, one tiny SG-RLVR
training step (also over fsdp-sharded params in a gloo world of one,
through parallel/, and split over tp = 2 in a gloo world of two), a tiny Qwen2-VL's speculative serving, speculative
rollout and HTTP server, and the tiny Aria family (text serving, an image
rollout, one image training step, an Aria checkpoint round trip) run on the
CPU through the kernels' plain versions (no kernel launch is counted
there); a checkpoint round trip needs neither the safetensors nor the
transformers package, and the eval harness runs a benchmark there."""

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
    cfg, params, proc, _ = load_model_and_processor(
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


# one rank of a tp-2 training step: a gloo world of 2 joined from torchrun's
# environment (the parent script starts both ranks), jax blocked in each
TP_RANK_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    for name in ("jax", "jaxlib", "spacer_tpu"):
        sys.modules[name] = None
    import numpy as np
    from spacer_tpu_torch.cli.common import (
        ModelArgs, load_model_and_processor, setup_distributed)
    from spacer_tpu_torch.data import make_conversation
    from spacer_tpu_torch.rewards import format_reward
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer
    margs = ModelArgs(random_init=True, dtype="float32", device="cpu",
                      multihost=True, tp=2)
    setup_distributed(margs)
    cfg, params, proc, mesh = load_model_and_processor(margs)
    assert mesh.shape == {"data": 1, "fsdp": 1, "tp": 2}, mesh
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    row = {"problem": "how many", "problem_type": "numerical",
           "solution": "<answer>1</answer>", "path": frames,
           "data_type": "video", "data_source": "synthetic"}
    row.update(make_conversation(row))
    args = SGRLVRConfig(num_generations=2, max_completion_length=4,
                        prompt_bucket=64, logp_chunk=4, decode_quant=None,
                        output_dir=tempfile.mkdtemp())
    trainer = SGRLVRTrainer(cfg, params, proc, [format_reward], [row], args,
                            mesh=mesh)
    m = trainer.training_step([row] if mesh.rank == 0 else [],
                              np.random.default_rng(0))
    assert np.isfinite(float(m["loss"])), m
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("tp step", repr(float(m["loss"])))
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
    cfg, params, proc, _ = load_model_and_processor(
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
    # the same step over fsdp-sharded params in a gloo world of one
    import os
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES, shard_params)
    store = multihost.local_store()
    os.environ.update(multihost.store_env(store, 0, 1))
    multihost.initialize(device="cpu")
    mesh = create_mesh({"data": 1, "fsdp": 1, "tp": 1})
    cfg, params, proc, _ = load_model_and_processor(
        ModelArgs(random_init=True, dtype="float32", device="cpu"))
    params, _ = shard_params(params, mesh, QWEN_PARTITION_RULES)
    args.output_dir = tempfile.mkdtemp()
    sharded = SGRLVRTrainer(cfg, params, proc, [format_reward], [row], args,
                            mesh=mesh)
    m2 = sharded.training_step([row], np.random.default_rng(0))
    assert float(m2["loss"]) == float(m["loss"]), (m, m2)
    assert set(launch_counts().values()) == {0}, launch_counts()
    # a tp-2 step: two ranks of TP_RANK_SCRIPT under torchrun's environment
    import subprocess
    store2 = multihost.local_store()
    ranks = [subprocess.Popen(
        [sys.executable, "-c", TP_RANK_SCRIPT_TEXT],
        env=dict(os.environ, **multihost.store_env(store2, r, 2),
                 PYTHONHASHSEED="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=240) for p in ranks]
    assert all(p.returncode == 0 for p in ranks), [e[-3000:] for _, e in outs]
    losses = {o.split("tp step")[1].strip() for o, _ in outs}
    assert len(losses) == 1, outs      # the loss replicated on both ranks
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("trained")
""").replace("TP_RANK_SCRIPT_TEXT", repr(TP_RANK_SCRIPT))


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


SERVE_SCRIPT = textwrap.dedent("""
    import http.client, json, sys
    for name in ("jax", "jaxlib", "spacer_tpu"):
        sys.modules[name] = None
    import numpy as np
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.sampler import Sampler
    from spacer_tpu_torch.serving import OpenAIServer
    cfg = tiny_config(arch="qwen2")
    params = init_params(cfg)
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    msgs = [[{"role": "user", "content": [
                {"type": "video", "video": frames, "fps": 2.0},
                {"type": "text", "text": "what moves"}]}],
            [{"role": "user", "content": "hello hello hello"}]]
    reset_launch_counts()
    engine = QwenEngine(cfg, params, proc, length_bucket=64, speculate_k=2)
    texts = engine.generate_many(msgs, max_new_tokens=6, temperature=0.0,
                                 slots=2)
    assert len(texts) == 2
    req = engine.encode_request(msgs[0])
    out = Sampler(cfg, length_bucket=64, speculate_k=2).generate(
        req["input_ids"], req["attention_mask"], params,
        position_ids=req["position_ids"], deltas=req["deltas"],
        vision_kwargs=req["vision_kwargs"], grid_thw=req["grid_thw"],
        num_generations=2, max_new_tokens=6, temperature=0.0)
    assert out.stats["spec_row_steps"] > 0
    srv = OpenAIServer(cfg, params, proc, slots=2, prompt_len=64,
                       max_new_tokens=6, temperature=0.0, speculate_k=2)
    port = srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(
        {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}))
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    srv.stop()
    assert set(launch_counts().values()) == {0}, launch_counts()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("served")
""")


ARIA_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    for name in ("jax", "jaxlib", "spacer_tpu", "safetensors", "transformers"):
        sys.modules[name] = None
    import numpy as np
    import torch
    from spacer_tpu_torch.cli.common import ModelArgs, load_model_and_processor
    from spacer_tpu_torch.data import make_conversation
    from spacer_tpu_torch.data.aria_processor import AriaProcessor
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.aria import (
        export_to_safetensors, load_params_from_hf)
    from spacer_tpu_torch.models.registry import aria_positions, get_family
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.rewards import format_reward
    from spacer_tpu_torch.sampler import Sampler
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer
    cfg, params, proc, _ = load_model_and_processor(ModelArgs(
        random_init=True, model_family="aria", dtype="float32", device="cpu"))
    reset_launch_counts()
    texts = QwenEngine(cfg, params, proc, length_bucket=32).generate_many(
        [[{"role": "user", "content": "hello there"}]], max_new_tokens=4,
        temperature=0.0, slots=2)
    assert len(texts) == 1
    # crops of the tiny tower's size (the family's processor is the
    # reference's, with 490 / 980-pixel crops)
    proc = AriaProcessor(proc.tokenizer, cfg, max_image_size=56,
                         min_image_size=14, size_conversion={56: 8})
    img = np.random.default_rng(0).integers(0, 256, (40, 56, 3), np.uint8)
    enc = proc.process_messages([[{"role": "user", "content": [
        {"type": "image", "image": img}, {"type": "text", "text": "what"}]}]])
    pos, deltas = aria_positions(cfg, enc["input_ids"], enc["attention_mask"])
    out = Sampler(cfg, length_bucket=32).generate(
        enc["input_ids"], enc["attention_mask"], params, position_ids=pos,
        deltas=deltas, vision_kwargs=get_family("aria").pack_vision(enc)[0],
        num_generations=2, max_new_tokens=4, temperature=0.0)
    assert out.sequences.shape == (2, 4)
    row = {"problem": "how many", "problem_type": "numerical",
           "solution": "<answer>1</answer>", "path": img,
           "data_type": "image", "data_source": "synthetic"}
    row.update(make_conversation(row))
    args = SGRLVRConfig(num_generations=2, max_completion_length=4,
                        prompt_bucket=32, logp_chunk=4, decode_quant=None,
                        output_dir=tempfile.mkdtemp())
    m = SGRLVRTrainer(cfg, params, proc, [format_reward], [row],
                      args).training_step([row], np.random.default_rng(0))
    assert np.isfinite(float(m["loss"])), m
    d = export_to_safetensors(params, cfg, tempfile.mkdtemp() + "/ckpt")
    back, _ = load_params_from_hf(d, dtype=torch.float32, device="cpu")
    assert torch.equal(back["visual"]["encoder"][0]["mlp"]["fc1"]["kernel"],
                       params["visual"]["encoder"][0]["mlp"]["fc1"]["kernel"])
    assert set(launch_counts().values()) == {0}, launch_counts()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu", "safetensors",
                                  "transformers")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("aria ran")
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


def test_qwen2_vl_speculation_and_http_run_without_jax():
    """A tiny Qwen2-VL model: speculative serving and rollout, and an HTTP
    request to a speculating server, with jax and spacer_tpu blocked."""
    _run(SERVE_SCRIPT, "served")


def test_aria_serves_rolls_out_and_trains_without_jax():
    _run(ARIA_SCRIPT, "aria ran")


def test_checkpoint_and_eval_run_without_jax_safetensors_transformers():
    _run(EVAL_SCRIPT, "evaluated")


def test_no_jax_or_spacer_tpu_import_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|spacer_tpu)(\.|\s|$)",
                         re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py",
               REPO / "profile_train.py", REPO / "profile_serve.py",
               REPO / "profile_tp.py", REPO / "time_tp_collectives.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
