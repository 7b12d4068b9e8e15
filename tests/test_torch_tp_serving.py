"""Serving and evaluation over a tensor-parallel mesh on the CPU (gloo):

- `python -m spacer_tpu_torch.cli.serve` on a jsonl file (continuous and
  static serving) and `python -m spacer_tpu_torch.cli.evaluate` on a
  LongVideoBench JSON file, each on the tiny random model, once as one
  process and once under `torch.distributed.run --nproc_per_node 2` with
  `--multihost true --tp 2`: the output file, the merged results and the
  metrics rank 0 writes equal the one-process run's (greedy decode).
- The HTTP server at world 2 (parallel.multihost.launch_local): rank 0
  answers a chat request with the one-process server's answer, the
  follower takes the same steps and exits cleanly when rank 0 stops; and
  `cli/serve.py --http --tp 2` under `torch.distributed.run` answers.

Every process hashes the mock tokenizer's words alike (PYTHONHASHSEED=0).
The runs are independent process groups and go side by side."""

import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from spacer_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _env():
    return dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="0",
                OMP_NUM_THREADS="1")


def _cmd(module, argv, world):
    if world == 1:
        return [sys.executable, "-m", module, *argv]
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
            str(world), "--standalone", "-m", module, "--multihost", "true",
            "--tp", str(world), *argv]


def _http_port() -> int:
    """A port for the server under test to listen on."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmd, cwd):
    res = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def _video(root):
    import cv2

    path = root / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (128, 96))
    base = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    for t in range(60):
        w.write(np.roll(base, 2 * t, axis=1))
    w.release()
    return path


def _serve_argv(d, serving):
    rows = [{"prompt": "what is this"}, {"prompt": "and that one there"},
            {"messages": [{"role": "user", "content": "hi"}]},
            {"prompt": "where is the chair", "video": str(d.parent / "clip.mp4")}]
    inp = d / "in.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return ["--random_init", "true", "--dtype", "float32", "--device", "cpu",
            "--input_file", str(inp), "--output_file", str(d / "out.jsonl"),
            "--max_new_tokens", "8", "--temperature", "0", "--slots", "2",
            "--serving", serving]


def _eval_argv(d):
    rows = [{"id": i, "video_id": "clip", "question": q, "candidates": c,
             "correct_choice": 0, "question_category": "S2E",
             "topic_category": "t", "duration": 2.0}
            for i, (q, c) in enumerate([("What moves?", ["a", "b"]),
                                        ("Where to?", ["left", "right", "up"])])]
    data = d / "lvb.json"
    data.write_text(json.dumps(rows))
    return ["--task", "LongVideoBench", "--data_file", str(data),
            "--video_dir", str(d.parent), "--output_dir", str(d / "out"),
            "--num_frames", "4", "--max_new_tokens", "6", "--batch_size", "2",
            "--temperature", "0", "--random_init", "true", "--dtype",
            "float32", "--device", "cpu"]


# -- the HTTP server at world 2 -----------------------------------------------


def _server(params, cfg, follower=False):
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.serving import OpenAIServer

    proc = VLProcessor(MockTokenizer(cfg.text.vocab_size), cfg)
    return OpenAIServer(cfg, params, proc, model_name="tiny", slots=2,
                        prompt_len=64, max_new_tokens=8, temperature=0.0,
                        chunk_steps=3, follower=follower)


def _ask(port):
    import urllib.request

    body = json.dumps({"model": "tiny", "max_tokens": 6, "messages": [
        {"role": "user", "content": "how many chairs are there"}]}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _http_worker(rank, out_dir, world):
    """World 2: rank 0 serves over the tp-2 model, rank 1 follows; world 1:
    the one-process server."""
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel.fsdp import gather_params
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        qwen_tp_plan,
        shard_params,
    )

    cfg = tiny_config()
    params = init_params(cfg, seed=0)
    if world > 1:
        params = gather_params(shard_params(
            params, create_mesh({"tp": world}), QWEN_PARTITION_RULES,
            qwen_tp_plan(cfg))[0])
    server = _server(params, cfg, follower=rank != 0)
    if rank != 0:
        server.follow()       # returns once rank 0 stops
        return
    port = server.start(port=0)
    try:
        answer = [_ask(port), _ask(port)]
    finally:
        server.stop()
    with open(os.path.join(out_dir, f"http{world}.pkl"), "wb") as f:
        pickle.dump(answer, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_serving")
    _video(root)
    jobs = {}
    for world in (1, 2):
        for serving in ("continuous", "static"):
            d = root / f"serve_{serving}_{world}"
            d.mkdir()
            jobs[d.name] = (_cmd("spacer_tpu_torch.cli.serve",
                                 _serve_argv(d, serving), world), d)
        d = root / f"eval_{world}"
        d.mkdir()
        jobs[d.name] = (_cmd("spacer_tpu_torch.cli.evaluate", _eval_argv(d),
                             world), d)

    def http(world):
        multihost.launch_local(_http_worker, world, args=(str(root), world),
                               device="cpu", timeout=TIMEOUT, threads=1)
        with open(root / f"http{world}.pkl", "rb") as f:
            return pickle.load(f)

    hashseed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"      # the spawned servers' too
    try:
        with ThreadPoolExecutor(len(jobs) + 2) as pool:
            outs = {k: pool.submit(_run, cmd, d)
                    for k, (cmd, d) in jobs.items()}
            https = {w: pool.submit(http, w) for w in (1, 2)}
            out = {k: (f.result(), jobs[k][1]) for k, f in outs.items()}
            out.update({f"http{w}": f.result() for w, f in https.items()})
    finally:
        if hashseed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = hashseed
    return out


@pytest.mark.parametrize("serving", ["continuous", "static"])
def test_serve_cli_at_tp2_writes_world_ones_completions(runs, serving):
    stdout2, d2 = runs[f"serve_{serving}_2"]
    _, d1 = runs[f"serve_{serving}_1"]
    got = [json.loads(line) for line in open(d2 / "out.jsonl")]
    want = [json.loads(line) for line in open(d1 / "out.jsonl")]
    assert len(got) == len(want) == 4
    assert got == want
    # rank 0 alone reports (and writes)
    assert stdout2.count("wrote 4 completions") == 1


def test_evaluate_cli_at_tp2_writes_world_ones_results(runs):
    stdout2, d2 = runs["eval_2"]
    stdout1, d1 = runs["eval_1"]
    got = [json.loads(line)
           for line in open(d2 / "out" / "LongVideoBench_results.jsonl")]
    want = [json.loads(line)
            for line in open(d1 / "out" / "LongVideoBench_results.jsonl")]
    assert [g["id"] for g in got] == [0, 1]
    assert got == want
    m2 = json.loads(stdout2[stdout2.index("{"):])
    m1 = json.loads(stdout1[stdout1.index("{"):])
    assert m2 == m1
    assert stdout2.count("overall_accuracy") == 1     # rank 0 prints


def test_http_server_at_world_two_answers_as_one_process(runs):
    """Rank 0 answers (twice: the loop refills between requests) with the
    one-process server's completions; the follower returned (the launch
    joined both ranks)."""
    for (status, body), (status1, body1) in zip(runs["http2"], runs["http1"]):
        assert status == status1 == 200
        assert body["choices"] == body1["choices"]
        assert body["usage"] == body1["usage"]


def test_serve_cli_http_under_torchrun_at_tp2(tmp_path):
    """`torch.distributed.run --nproc_per_node 2 -m spacer_tpu_torch.cli.serve
    --multihost true --tp 2 --http`: rank 0 answers a chat request over its
    socket, with the tiny model split over both ranks; SIGTERM stops
    both."""
    import time
    import urllib.request

    port = _http_port()
    proc = subprocess.Popen(
        _cmd("spacer_tpu_torch.cli.serve",
             ["--http", "--random_init", "true", "--dtype", "float32",
              "--device", "cpu", "--port", str(port), "--prompt_len", "64",
              "--max_new_tokens", "6", "--slots", "2", "--temperature", "0"],
             2),
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + TIMEOUT
        while True:
            try:
                status, body = _ask(port)
                break
            except OSError:
                if time.time() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.5)
        assert status == 200
        assert body["choices"][0]["finish_reason"] in ("stop", "length")
        assert body["usage"]["completion_tokens"] >= 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        proc.terminate()
        proc.wait(timeout=60)
