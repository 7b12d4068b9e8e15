"""The OpenAI-compatible HTTP server of spacer_tpu_torch (serving/server.py):
real requests over a real socket against the tiny model on the CPU, the
cases of tests/test_http_server.py run against the port's server (schema,
concurrency with refill, `n`, SSE streaming, 413, a malformed request that
fails alone, 404, the distill tool's round trip), plus: greedy answers
equal to JAX's server on the same converted weights, a speculating server,
OpenAI image_url content, a failing device step failing every request, and
the serve CLI's --http / --serving static / --speculate_k plumbing.
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spacer_tpu.data.processor import MockTokenizer as JaxTokenizer
from spacer_tpu.data.processor import VLProcessor as JaxProcessor
from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.serving import OpenAIServer as JaxServer
from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.serving import OpenAIServer, ServingLoop
from spacer_tpu_torch.serving.server import encode_chat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(model_name="tiny", slots=2, prompt_len=64, max_new_tokens=16,
          temperature=0.0, chunk_steps=4)


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(0), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def _proc(cfg, cls=VLProcessor, tok=MockTokenizer):
    return cls(tok(vocab_size=cfg.text.vocab_size), cfg, min_pixels=3136,
               max_pixels=12544)


@pytest.fixture(scope="module")
def server(weights):
    cfg, _, tparams = weights
    srv = OpenAIServer(cfg, tparams, _proc(cfg), **KW)
    port = srv.start()
    yield srv, port
    srv.stop()


def _post(port, path, payload, timeout=300, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=raw if raw is not None else json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _chat(content, max_tokens=8, **extra):
    return {"model": "tiny", "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, **extra}


def test_health_and_models(server):
    _, port = server
    status, out = _get(port, "/health")
    assert status == 200 and out["status"] == "ok"
    status, out = _get(port, "/v1/models")
    assert status == 200 and out["data"][0]["id"] == "tiny"


def test_chat_completion_schema(server):
    _, port = server
    status, out = _post(port, "/v1/chat/completions", _chat("hello world"))
    assert status == 200, out
    assert out["object"] == "chat.completion"
    choice = out["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    assert choice["finish_reason"] in ("stop", "length")
    usage = out["usage"]
    assert usage["prompt_tokens"] > 0 and usage["completion_tokens"] > 0
    assert usage["total_tokens"] == (usage["prompt_tokens"]
                                     + usage["completion_tokens"])


def test_plain_completions_endpoint(server):
    _, port = server
    status, out = _post(port, "/v1/completions",
                        {"model": "tiny", "prompt": "tell me", "max_tokens": 6})
    assert status == 200, out
    assert out["object"] == "text_completion"
    assert isinstance(out["choices"][0]["text"], str)


def test_concurrent_requests_share_the_slots(server):
    """Four concurrent requests through 2 slots: all finish, and identical
    greedy prompts give identical answers whatever slot they took."""
    _, port = server
    results = {}

    def worker(i):
        results[i] = _post(port, "/v1/chat/completions", _chat("same prompt"))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert len(results) == 4
    for status, out in results.values():
        assert status == 200, out
    assert len({out["choices"][0]["message"]["content"]
                for _, out in results.values()}) == 1


def test_prompt_too_long_is_413(server):
    _, port = server
    status, out = _post(port, "/v1/chat/completions",
                        _chat("word " * 400, max_tokens=4))
    assert status == 413 and "bucket" in out["error"]


def test_malformed_request_fails_alone(server):
    """Out-of-vocabulary ids are refused at submit time (the loop lives
    on), as are bad JSON and a bad messages field (HTTP 400)."""
    srv, port = server
    vocab = srv.cfg.text.vocab_size
    bad = {"input_ids": np.array([[vocab + 5, 3, 4]], np.int32),
           "attention_mask": np.ones((1, 3), np.int32),
           "position_ids": np.broadcast_to(
               np.arange(3)[None, None], (3, 1, 3)).astype(np.int32)}
    with pytest.raises(ValueError, match="vocab_size"):
        srv.loop.submit(bad)
    assert _post(port, "/v1/chat/completions", None, raw="{not json")[0] == 400
    assert _post(port, "/v1/chat/completions",
                 {"messages": [{"role": "user", "content": 5}]})[0] == 400
    status, out = _post(port, "/v1/chat/completions",
                        _chat("still alive?", max_tokens=4))
    assert status == 200
    assert out["choices"][0]["finish_reason"] in ("stop", "length")


def test_n_generations_and_distill_tool_roundtrip(server):
    """OpenAI `n` gives n indexed choices, and tools/generate_distill_data.py
    round-trips against the server through an OpenAI-shaped client."""
    from tools.generate_distill_data import generate_rows

    _, port = server
    status, out = _post(port, "/v1/chat/completions",
                        _chat("two please", max_tokens=4, n=2))
    assert status == 200
    assert [c["index"] for c in out["choices"]] == [0, 1]
    assert all(c["message"]["content"] for c in out["choices"])

    def create(*, model, messages, **kw):
        status, out = _post(port, "/v1/chat/completions", {
            "model": model, "messages": messages,
            "max_tokens": kw.get("max_tokens"), "n": kw.get("n", 1)})
        assert status == 200
        return types.SimpleNamespace(choices=[
            types.SimpleNamespace(message=types.SimpleNamespace(
                content=c["message"]["content"])) for c in out["choices"]])

    client = types.SimpleNamespace(chat=types.SimpleNamespace(
        completions=types.SimpleNamespace(create=create)))
    rows = generate_rows(client, "tiny", ["prompt one", "prompt two"],
                         max_new_tokens=4, num_generations=2, workers=2)
    assert len(rows) == 2 and all(len(r["generations"]) == 2 for r in rows)


def _stream(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/chat/completions",
                 body=json.dumps({**payload, "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events, done = [], False
    while True:
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            break
        events.append(json.loads(line[len("data: "):]))
    conn.close()
    return events, done


def test_streaming_chat_completion(server):
    """stream=true: chat.completion.chunk events whose deltas concatenate
    to the non-streaming answer, a finish_reason chunk, `data: [DONE]`."""
    _, port = server
    payload = _chat("stream this")
    status, plain = _post(port, "/v1/chat/completions", payload)
    assert status == 200
    events, done = _stream(port, payload)
    assert done
    assert all(e["object"] == "chat.completion.chunk" for e in events)
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
    assert text == plain["choices"][0]["message"]["content"]
    assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_unknown_route_404(server):
    _, port = server
    assert _post(port, "/v1/embeddings", {"input": "x"})[0] == 404
    assert _get(port, "/v2/nothing")[0] == 404


def test_greedy_answers_match_jax_server(weights, server):
    """The same chat and completion requests to JAX's server and the
    port's: identical greedy texts and usage."""
    cfg, params, _ = weights
    jsrv = JaxServer(cfg, params, _proc(cfg, JaxProcessor, JaxTokenizer),
                     dtype=jnp.float32, **KW)
    jport = jsrv.start()
    try:
        _, port = server
        for path, body in (("/v1/chat/completions", _chat("compare me")),
                           ("/v1/chat/completions", _chat("and me", n=2)),
                           ("/v1/completions", {"prompt": "plain one",
                                                "max_tokens": 12})):
            (s1, a), (s2, b) = (_post(p, path, body) for p in (port, jport))
            assert s1 == s2 == 200
            assert a["choices"] == b["choices"] and a["usage"] == b["usage"]
    finally:
        jsrv.stop()


def test_speculating_server_matches_the_plain_one(weights, server):
    """OpenAIServer(speculate_k=3): the same greedy answers, drafts
    accepted."""
    cfg, _, tparams = weights
    srv = OpenAIServer(cfg, tparams, _proc(cfg), speculate_k=3, **KW)
    sport = srv.start()
    try:
        _, port = server
        for text in ("one two one two one two", "count the chairs"):
            a = _post(port, "/v1/chat/completions", _chat(text, 16))[1]
            b = _post(sport, "/v1/chat/completions", _chat(text, 16))[1]
            assert a["choices"] == b["choices"]
        events, done = _stream(sport, _chat("stream speculation", 16))
        assert done and events[-1]["choices"][0]["finish_reason"]
        stats = srv.batcher.spec_stats
        assert 0 < stats["steps"] <= stats["tokens"]
    finally:
        srv.stop()


def test_image_url_content_encodes_as_an_image(weights, tmp_path):
    """OpenAI {"type": "image_url"} content becomes a processor image: the
    request carries the image's patches and placeholder tokens."""
    from PIL import Image

    cfg = weights[0]
    path = str(tmp_path / "image.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (56, 84, 3), np.uint8)).save(path)
    req = encode_chat(_proc(cfg), cfg, [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": path}},
        {"type": "text", "text": "what is it"}]}])
    (t, h, w), = req["grid_thw"]
    assert req["vision_kwargs"]["pixel_values"].shape[0] == t * h * w
    assert int((req["input_ids"] == cfg.image_token_id).sum()) == t * h * w // 4


def test_failed_step_fails_every_request(weights):
    """A device step that raises fails the requests in flight and the queue
    with its message, and the loop refuses new requests."""
    cfg, _, tparams = weights
    srv = OpenAIServer(cfg, tparams, _proc(cfg), **dict(KW, slots=1))
    req, _ = srv._encode([{"role": "user", "content": "x"}], 8)
    gate = threading.Event()

    def broken():
        gate.wait(30)
        raise RuntimeError("device fault")

    srv.batcher.decode_chunk = broken
    pend = [srv.loop.submit(dict(req)) for _ in range(3)]   # 1 slot: 2 queued
    gate.set()
    for p in pend:
        with pytest.raises(RuntimeError, match="device fault"):
            srv.loop.result(p, timeout=60)
    with pytest.raises(RuntimeError, match="died"):
        srv.loop.submit(dict(req))
    srv.stop()
    assert srv.loop.died.startswith("RuntimeError")


def test_serving_loop_drives_a_batcher_directly(weights):
    """ServingLoop over a bare ContinuousBatcher: results equal run()'s."""
    from spacer_tpu_torch.serving import ContinuousBatcher

    cfg, _, tparams = weights
    rng = np.random.RandomState(0)
    reqs = [{"input_ids": rng.randint(10, 500, (1, S)),
             "attention_mask": np.ones((1, S), np.int32),
             "position_ids": np.broadcast_to(np.arange(S)[None, None],
                                             (3, 1, S)).copy()}
            for S in (5, 9, 7)]
    kw = dict(slots=2, prompt_len=16, max_new_tokens=8, eos_token_id=11,
              temperature=0.0, chunk_steps=3)
    ref = ContinuousBatcher(cfg, tparams, **kw).run(reqs)
    loop = ServingLoop(ContinuousBatcher(cfg, tparams, **kw))
    try:
        got = [loop.result(p, timeout=120)
               for p in [loop.submit(r) for r in reqs]]
    finally:
        loop.shutdown()
    for a, b in zip(got, ref):
        assert a.length == b.length
        np.testing.assert_array_equal(a.sequences[:a.length],
                                      b.sequences[:b.length])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_http(tmp_path):
    """`python -m spacer_tpu_torch.cli.serve --http` answers a chat request
    over its socket (speculating), and stops on SIGTERM."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacer_tpu_torch.cli.serve", "--http",
         "--random_init", "true", "--dtype", "float32", "--device", "cpu",
         "--port", str(port), "--prompt_len", "128", "--max_new_tokens", "8",
         "--slots", "2", "--speculate_k", "2"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                status, out = _post(port, "/v1/chat/completions",
                                    _chat("hi there", 4))
                break
            except OSError:
                if time.time() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.5)
        assert status == 200 and out["choices"][0]["finish_reason"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)


@pytest.mark.parametrize("argv,match", [
    (["--serving", "static", "--speculate_k", "2"], "continuous"),
    (["--serving", "batch"], "static"),
    ([], "input_file")])
def test_serve_cli_refusals_come_before_the_load(monkeypatch, argv, match):
    """--speculate_k with --serving static, an unknown --serving and a
    missing --input_file exit before any model is built."""
    import spacer_tpu_torch.cli.serve as serve

    def no_load(args):
        raise AssertionError("the model was loaded before the refusal")

    monkeypatch.setattr(serve, "load_model_and_processor", no_load)
    if argv:
        argv = argv + ["--input_file", "in.jsonl"]
    with pytest.raises(SystemExit, match=match):
        serve.main(argv + ["--device", "cpu", "--random_init", "true"])


def test_serve_cli_static_serving(tmp_path):
    """--serving static writes one completion per row through
    QwenEngine.generate; greedy, the same texts as continuous serving."""
    from spacer_tpu_torch.cli.serve import main

    rows = [{"prompt": "what is this"}, {"prompt": "and that one"},
            {"messages": [{"role": "user", "content": "hi"}]}]
    (tmp_path / "in.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    texts = {}
    for serving in ("static", "continuous"):
        out = tmp_path / f"{serving}.jsonl"
        main(["--random_init", "true", "--dtype", "float32", "--device", "cpu",
              "--input_file", str(tmp_path / "in.jsonl"), "--output_file",
              str(out), "--max_new_tokens", "6", "--temperature", "0",
              "--serving", serving])
        texts[serving] = [json.loads(line)["completion"]
                          for line in out.read_text().splitlines()]
    assert len(texts["static"]) == 3
    assert texts["static"] == texts["continuous"]
