"""Online serving: a threaded continuous-batching loop and an
OpenAI-compatible HTTP front end, standard library only (counterpart of
spacer_tpu/serving/server.py).

Requests arrive on ThreadingHTTPServer handler threads, are encoded there
(tokens, rope positions and pixel patches as host numpy: the handlers'
processor runs on the CPU) and queued; one serving thread drives the
ContinuousBatcher (admission -> decode chunk -> retirement), so every
device tensor is touched by that thread alone, and finished slots refill
between concurrent requests.

Endpoints:
  GET  /health                 -> {"status": "ok"}
  GET  /v1/models              -> model listing
  POST /v1/chat/completions    -> OpenAI chat schema (`n`; `stream` as SSE)
  POST /v1/completions         -> plain-prompt variant

One server is one geometry (prompt_len and max_new_tokens buckets) and one
sampling temperature; a prompt longer than the bucket gets HTTP 413, a
malformed request 400, an unknown route 404.  Multimodal content uses the
processor's message schema ({"type": "video" | "image", ...}) plus OpenAI's
{"type": "image_url"}, which is translated.

Program spans (utils/profiling.py; no-ops unless recording): `loop.idle`
(waiting for work), `loop.iteration` (one admit / chunk / feed round, over
the batcher's spans) and `loop.feed` (retirement and the stream puts); per
request, under its id, `serve.queued` (submit to the start of the round that
admits it) and the instant `serve.first_token` (its first token reaches the
stream, or its output when it does not stream).
"""

from __future__ import annotations

import copy
import itertools
import json
import queue as _queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from spacer_tpu_torch.utils import profiling

_request_ids = itertools.count()


class _Pending:
    __slots__ = ("event", "output", "error", "tokens", "pushed", "id",
                 "submitted_ns")

    def __init__(self, stream: bool = False):
        # while the program records: the request's id in its spans, and
        # when it was submitted (perf_counter_ns, its serve.queued start)
        self.id = self.submitted_ns = None
        if profiling.enabled():
            self.id = next(_request_ids)
            self.submitted_ns = time.perf_counter_ns()
        self.event = threading.Event()
        self.output = None
        self.error: Optional[str] = None
        # streaming requests get a token feed: items are
        # ("tokens", list[int]) | ("done", ServedOutput) | ("error", str)
        self.tokens = _queue.Queue() if stream else None
        self.pushed = 0   # emitted tokens already fed (serving thread only)


# an idle lockstep loop tells its followers it is alive this often (s), so
# that none waits out the process group's timeout in its broadcast
IDLE_BEAT_S = 10.0


class ServingLoop:
    """One background thread driving a ContinuousBatcher.

    submit() is thread-safe (it validates the request on the caller's
    thread, host-side only) and returns a handle; result(handle) blocks
    until that request retires.  The loop admits from the queue whenever
    slots free up, so concurrent requests share decode steps.  If a device
    step fails, every request fails (the wave being admitted, the slots in
    flight and the queue) and the loop stops: the slot state can no longer
    be trusted.

    `lockstep` (a model split over a process group: rank 0's loop) makes
    the loop broadcast every wave's admissions before it steps, ("idle",)
    while it waits and ("stop",) or ("error", message) when it ends; the
    other ranks run `follow` on the same batcher geometry and take the
    same steps."""

    def __init__(self, batcher, lockstep: bool = False):
        self.batcher = batcher
        self.lockstep = lockstep
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stop = False
        self._died: Optional[str] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="spacer-serving-loop")
        self._thread.start()

    def submit(self, request: dict, max_new_tokens: Optional[int] = None,
               stream: bool = False) -> _Pending:
        # a malformed request (out-of-vocabulary ids, over the bucket)
        # raises here and fails alone
        self.batcher.validate_request(request)
        pending = _Pending(stream=stream)
        budget = self.batcher.budget_of(request, max_new_tokens)
        with self._cv:
            if self._stop:
                raise RuntimeError(
                    "serving loop stopped"
                    + (f" (died: {self._died})" if self._died else ""))
            self._queue.append((pending, request, budget))
            self._cv.notify()
        return pending

    def result(self, pending: _Pending, timeout: Optional[float] = None):
        if not pending.event.wait(timeout):
            raise TimeoutError("request did not finish in time")
        if pending.error:
            raise RuntimeError(pending.error)
        return pending.output

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=60)

    @property
    def died(self) -> Optional[str]:
        """The error that stopped the loop, or None."""
        return self._died

    # -- serving thread ---------------------------------------------------

    def _tell(self, kind: str, payload=None):
        """Broadcast a message to the lockstep followers (no-op alone)."""
        if self.lockstep:
            from spacer_tpu_torch.parallel import multihost

            multihost.broadcast_from_host0((kind, payload))

    def _run(self):
        b = self.batcher
        if b.device.type == "cuda":
            torch.cuda.set_device(b.device)
        while True:
            with self._cv:
                if not self._queue and not b.has_active():
                    with profiling.span("loop.idle"):
                        if self._wait_for_work():
                            return
                admissions = []
                for slot in b.free_slots():
                    if not self._queue:
                        break
                    pending, req, budget = self._queue.popleft()
                    admissions.append((pending, req, budget, slot))
            with profiling.span("loop.iteration"):
                try:
                    self._step(admissions)
                except Exception as e:  # noqa: BLE001
                    msg = f"{type(e).__name__}: {e}"
                    self._fail_all(msg, admissions)
                    self._tell("error", msg)
                    return

    def _wait_for_work(self) -> bool:
        """Wait (holding the condition) until a request is queued or a slot
        is active; True once the loop is told to stop instead."""
        b = self.batcher
        idle = time.monotonic()
        while not self._queue and not b.has_active():
            if self._stop:
                self._tell("stop")
                return True
            self._cv.wait(timeout=0.5)
            if time.monotonic() - idle > IDLE_BEAT_S:
                self._tell("idle")
                idle = time.monotonic()
        return False

    def _step(self, admissions: list) -> None:
        """One round: admit the wave, decode a chunk, retire and feed."""
        b = self.batcher
        self._tell("step", [(req, budget, slot)
                            for _p, req, budget, slot in admissions])
        if admissions:
            for pending, *_ in admissions:
                if pending.id is not None:
                    profiling.event("serve.queued", request=pending.id,
                                    start_ns=pending.submitted_ns)
            b.admit(admissions)
        b.decode_chunk()
        with profiling.span("loop.feed"):
            for pending, served in b.poll_finished():
                pending.output = served
                if pending.pushed == 0 and pending.id is not None:
                    profiling.event("serve.first_token", request=pending.id)
                if pending.tokens is not None:
                    pending.tokens.put(("done", served))
                pending.event.set()
            # feed in-flight streaming requests (one fetch of the token
            # buffer per chunk, only while someone streams)
            if any(isinstance(t, _Pending) and t.tokens is not None
                   for t in b._slot_req):
                for tag, toks, t in b.poll_progress():
                    if (isinstance(tag, _Pending) and tag.tokens is not None
                            and t > tag.pushed):
                        tag.tokens.put(("tokens", toks[tag.pushed:t].tolist()))
                        if tag.pushed == 0 and tag.id is not None:
                            profiling.event("serve.first_token",
                                            request=tag.id)
                        tag.pushed = t

    def _fail_all(self, msg: str, admissions: list) -> None:
        b = self.batcher
        dead = [pending for pending, *_ in admissions]
        for slot, tag in enumerate(b._slot_req):
            if tag is not None:
                dead.append(tag)
                b._slot_req[slot] = None
        with self._cv:
            self._died = msg
            self._stop = True
            while self._queue:
                dead.append(self._queue.popleft()[0])
        for pending in dead:
            if isinstance(pending, _Pending):
                pending.error = msg
                if pending.tokens is not None:
                    pending.tokens.put(("error", msg))
                pending.event.set()


def follow(batcher) -> None:
    """A lockstep follower (ranks other than 0 of a split model): take rank
    0's serving steps on this rank's batcher until its loop stops.  A step
    that fails here stops the stepping; the failure is raised when rank 0
    reports its own end, so no rank is left in a collective."""
    from spacer_tpu_torch.parallel import multihost

    if batcher.device.type == "cuda":
        torch.cuda.set_device(batcher.device)
    failed = None
    while True:
        kind, payload = multihost.broadcast_from_host0(None)
        if kind == "idle":
            continue
        if kind in ("stop", "error"):
            if failed is not None:
                raise failed
            if kind == "error":
                raise RuntimeError(f"the serving loop of rank 0 died: "
                                   f"{payload}")
            return
        if failed is not None:
            continue
        try:
            if payload:
                batcher.admit([(slot, req, budget, slot)
                               for req, budget, slot in payload])
            batcher.decode_chunk()
            batcher.poll_finished()
        except Exception as e:  # noqa: BLE001
            failed = e


def _to_processor_content(content) -> list:
    """OpenAI message content -> processor content list."""
    if isinstance(content, str):
        return [{"type": "text", "text": content}]
    out = []
    for item in content:
        if item.get("type") == "image_url":
            url = item["image_url"]
            if isinstance(url, dict):
                url = url.get("url", "")
            out.append({"type": "image", "image": url})
        else:
            out.append(dict(item))
    return out


def encode_chat(processor, cfg, messages: list) -> dict:
    """OpenAI-schema messages -> a ContinuousBatcher request
    (models/registry.py encode_request after content normalization)."""
    from spacer_tpu_torch.models.registry import encode_request

    norm = [{"role": m.get("role", "user"),
             "content": _to_processor_content(m.get("content", ""))}
            for m in messages]
    return encode_request(processor, cfg, norm)


class _HttpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class OpenAIServer:
    """stdlib HTTP server speaking the OpenAI completion schema over one
    ContinuousBatcher on the params' device (`decode_quant` and
    `speculate_k` as the batcher takes them).  Over a process group (a
    model split by tensor parallelism) rank 0's server listens and steps
    in lockstep with the others, built with `follower=True`, whose
    `follow()` runs its steps until it stops."""

    def __init__(self, cfg, params, processor, *, model_name: str = "spacer",
                 slots: int = 4, prompt_len: int = 1024,
                 max_new_tokens: int = 512, temperature: float = 0.01,
                 top_p: float = 1.0, chunk_steps: int = 16,
                 decode_quant: Optional[str] = None, speculate_k: int = 0,
                 request_timeout: float = 600.0, follower: bool = False):
        from spacer_tpu_torch.parallel import multihost
        from spacer_tpu_torch.serving.batcher import ContinuousBatcher

        self.cfg = cfg
        self.processor = processor
        # the handler threads' processor: the same one on the CPU, so that
        # no handler thread touches the card
        self.encoder = copy.copy(processor)
        self.encoder.device = torch.device("cpu")
        self.model_name = model_name
        self.prompt_len = prompt_len
        self.request_timeout = request_timeout
        self._ids = itertools.count()
        self.batcher = ContinuousBatcher(
            cfg, params, slots=slots, prompt_len=prompt_len,
            max_new_tokens=max_new_tokens,
            eos_token_id=processor.eos_token_id,
            pad_token_id=processor.pad_token_id, temperature=temperature,
            top_p=top_p, chunk_steps=chunk_steps, decode_quant=decode_quant,
            speculate_k=speculate_k)
        self.loop = None if follower else ServingLoop(
            self.batcher, lockstep=multihost.process_count() > 1)
        self._httpd: Optional[ThreadingHTTPServer] = None

    def follow(self) -> None:
        """A follower's serving: rank 0's steps, until its loop stops."""
        follow(self.batcher)

    # -- request handling -------------------------------------------------

    def _encode(self, messages: list, max_tokens: Optional[int]):
        if not isinstance(messages, list) or not messages:
            raise _HttpError(400, "messages must be a non-empty list")
        try:
            req = encode_chat(self.encoder, self.cfg, messages)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise _HttpError(400, f"{type(e).__name__}: {e}")
        n_prompt = int(np.asarray(req["attention_mask"]).sum())
        if req["input_ids"].shape[1] > self.prompt_len:
            raise _HttpError(
                413, f"prompt length {req['input_ids'].shape[1]} exceeds "
                     f"this deployment's bucket {self.prompt_len}")
        if max_tokens:
            req["max_new_tokens"] = int(max_tokens)
        return req, n_prompt

    def _decode_text(self, token_ids) -> str:
        return self.processor.tokenizer.batch_decode(
            [np.asarray(token_ids)], skip_special_tokens=True)[0]

    def _finish_reason(self, served, req) -> str:
        return ("length" if served.length >= self.batcher.budget_of(req)
                else "stop")

    def _complete(self, messages: list, max_tokens: Optional[int],
                  n: int = 1) -> dict:
        """n > 1 (OpenAI `n`): the prompt is submitted n times and the slots
        decode the copies concurrently."""
        req, n_prompt = self._encode(messages, max_tokens)
        n = max(1, int(n or 1))
        try:
            pendings = [self.loop.submit(dict(req)) for _ in range(n)]
        except ValueError as e:
            raise _HttpError(400, str(e))
        choices, total = [], 0
        for i, pending in enumerate(pendings):
            served = self.loop.result(pending, timeout=self.request_timeout)
            choices.append({
                "index": i,
                "message": {"role": "assistant", "content": self._decode_text(
                    served.sequences[:served.length])},
                "finish_reason": self._finish_reason(served, req),
            })
            total += int(served.length)
        return {
            "id": f"chatcmpl-{next(self._ids)}",
            "object": "chat.completion",
            "model": self.model_name,
            "choices": choices,
            "usage": {"prompt_tokens": n_prompt, "completion_tokens": total,
                      "total_tokens": n_prompt + total},
        }

    # -- http plumbing ----------------------------------------------------

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000):
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        try:
            self._httpd.serve_forever()
        finally:
            self.loop.shutdown()

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Non-blocking start; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="spacer-http").start()
        return self._httpd.server_address[1]

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.loop.shutdown()

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    return self._send(200, {"status": "ok"})
                if self.path == "/v1/models":
                    return self._send(200, {"object": "list", "data": [
                        {"id": server.model_name, "object": "model"}]})
                return self._send(404, {"error": "not found"})

            def _sse_chat(self, body: dict):
                """OpenAI streaming: chat.completion.chunk events over
                text/event-stream, closed by `data: [DONE]`.  Deltas are
                string differences of the cumulatively decoded tokens, so a
                character of several tokens never splits."""
                if int(body.get("n", 1) or 1) > 1:
                    return self._send(
                        400, {"error": "stream does not support n > 1"})
                try:
                    req, _ = server._encode(body.get("messages", []),
                                            body.get("max_tokens"))
                    pending = server.loop.submit(req, stream=True)
                except _HttpError as e:
                    return self._send(e.code, {"error": e.message})
                except ValueError as e:
                    return self._send(400, {"error": str(e)})
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                cid = f"chatcmpl-{next(server._ids)}"

                def chunk(delta: dict, finish=None):
                    payload = {"id": cid, "object": "chat.completion.chunk",
                               "model": server.model_name,
                               "choices": [{"index": 0, "delta": delta,
                                            "finish_reason": finish}]}
                    self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                    self.wfile.flush()

                chunk({"role": "assistant"})
                sent, toks = "", []
                deadline = time.time() + server.request_timeout
                while True:
                    try:
                        kind, val = pending.tokens.get(
                            timeout=max(1.0, deadline - time.time()))
                    except _queue.Empty:
                        chunk({}, finish="error")
                        break
                    if kind == "error":
                        chunk({}, finish="error")
                        break
                    if kind == "tokens":
                        toks.extend(val)
                        text = server._decode_text(toks)
                    else:
                        text = server._decode_text(val.sequences[:val.length])
                    delta = text[len(sent):] if text.startswith(sent) else text
                    if delta:
                        chunk({"content": delta})
                        sent = text
                    if kind == "done":
                        chunk({}, finish=server._finish_reason(val, req))
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                        break

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError as e:
                        raise _HttpError(400, f"malformed JSON: {e}")
                    if not isinstance(body, dict):
                        raise _HttpError(400, "the body must be a JSON object")
                    if self.path == "/v1/chat/completions":
                        if body.get("stream"):
                            return self._sse_chat(body)
                        out = server._complete(body.get("messages", []),
                                               body.get("max_tokens"),
                                               n=body.get("n", 1))
                    elif self.path == "/v1/completions":
                        messages = [{"role": "user",
                                     "content": body.get("prompt", "")}]
                        out = server._complete(messages, body.get("max_tokens"),
                                               n=body.get("n", 1))
                        out["object"] = "text_completion"
                        out["choices"] = [{
                            "index": c["index"],
                            "text": c["message"]["content"],
                            "finish_reason": c["finish_reason"],
                        } for c in out["choices"]]
                    else:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, out)
                except _HttpError as e:
                    return self._send(e.code, {"error": e.message})
                except Exception as e:  # noqa: BLE001
                    return self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler
