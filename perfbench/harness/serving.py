"""What the serving drivers share: the system under test built from a
cell's files (the port's ContinuousBatcher behind its ServingLoop, with the
timing proxy between them), the requests in the batcher's format, the
warm-up, and the per-request record a run leaves for the metric readers.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
import types

import numpy as np
import torch

from harness import check
from harness import requests as prompts
from harness import traffic, weights
from harness.proxy import BatcherProxy


def log(msg: str) -> None:
    """A progress line on standard error (the result line is on stdout)."""
    print(f"[perfbench {time.perf_counter():.3f}] {msg}", file=sys.stderr,
          flush=True)


def port_config(config: dict):
    """The port's configuration object of a configuration file."""
    family = config["family"]
    if family == "qwen25_vl":
        from spacer_tpu_torch.models.qwen25_vl.config import Qwen25VLConfig

        return Qwen25VLConfig.from_hf_config(config["model"])
    if family == "aria":
        from spacer_tpu_torch.models.aria.config import AriaConfig

        return AriaConfig.from_hf_config(config["model"])
    raise ValueError(f"unknown family {family!r}")


def to_request(cfg, inp: dict, budget: int) -> dict:
    """One prompt as the batcher takes it; its rope positions are the
    program's own (models/registry.py, as the HTTP handlers compute them)."""
    from spacer_tpu_torch.models.registry import family_for_config

    ids = inp["ids"][None]
    mask = np.ones_like(ids)
    enc = {}
    if inp["grid"] is not None:
        enc = {"video_grid_thw": np.asarray([inp["grid"]]),
               "second_per_grid_ts": np.asarray([inp["second_per_grid"]])}
    pos, deltas = family_for_config(cfg).positions(cfg, ids, mask, enc)
    req = {"input_ids": ids, "attention_mask": mask, "position_ids": pos,
           "deltas": deltas, "max_new_tokens": int(budget), "grid_thw": None}
    if inp["grid"] is not None:
        req["grid_thw"] = (tuple(int(g) for g in inp["grid"]),)
        req["vision_kwargs"] = {"pixel_values": inp["pixels"]}
    return req


class Serving:
    """The system under test for one run, and its inputs."""

    def __init__(self, cell, seed: int, seconds: float, device, trace: bool):
        from spacer_tpu_torch.serving.batcher import ContinuousBatcher
        from spacer_tpu_torch.serving.server import ServingLoop

        self.cell, self.seed, self.device = cell, seed, device
        cfgf, tr = cell.config, cell.traffic
        self.cfg = port_config(cfgf)
        assumed = cfgf.get("assumed", {})
        self.params = weights.make(cfgf["family"], cfgf["model"], assumed,
                                   seed, device)
        n_params = weights.count(cfgf["family"], cfgf["model"], assumed)
        log(f"weights made: {n_params / 1e9:.3f} B parameters")
        n = traffic.request_count(tr, seconds)
        self.shapes = traffic.deck(tr["fields"], n, seed)
        self.due = traffic.arrivals(tr["arrivals"], n, seed)
        self.inputs = prompts.build(cfgf, tr["prompt"], self.shapes, seed, device)
        self.requests = [to_request(self.cfg, x, s["max_new_tokens"])
                         for x, s in zip(self.inputs, self.shapes)]
        sv = tr["serving"]
        self.batcher = ContinuousBatcher(
            self.cfg, self.params, slots=sv["slots"], prompt_len=sv["prompt_len"],
            max_new_tokens=sv["max_new_tokens"],
            eos_token_id=cfgf["eos_token_id"], pad_token_id=cfgf["pad_token_id"],
            temperature=0.0, decode_quant=sv.get("decode_quant"),
            chunk_steps=sv["chunk_steps"], seed=seed % 2 ** 63)
        self.proxy = BatcherProxy(self.batcher,
                                  sync=trace and device.type == "cuda")
        self.loop = ServingLoop(self.proxy)
        log(f"{n} requests made; batcher built")

    def warm_up(self):
        """Serves the traffic file's warm-up requests (their own seed), each
        shape the window uses at least once: every distinct prompt kind and
        size class, and a wave as wide as `warmup.wave`."""
        w = self.cell.traffic["warmup"]
        tr = self.cell.traffic
        n = w["requests"]
        shapes = traffic.deck(tr["fields"], n, self.seed + 1)
        for s in shapes:
            s["max_new_tokens"] = min(s["max_new_tokens"], w["max_new_tokens"])
        inputs = prompts.build(self.cell.config, tr["prompt"], shapes,
                               self.seed + 1, self.device)
        reqs = [to_request(self.cfg, x, s["max_new_tokens"])
                for x, s in zip(inputs, shapes)]
        for start in range(0, n, w["wave"]):
            pend = [self.loop.submit(r, stream=True)
                    for r in reqs[start:start + w["wave"]]]
            for p in pend:
                self.loop.result(p, timeout=600)
        self.proxy.reset()
        log(f"warm-up done: {n} requests")

    @contextlib.contextmanager
    def stopped_on_error(self):
        """Stop the serving thread if the body raises, so that no thread
        outlives the run."""
        try:
            yield
        except BaseException:
            self.free()
            raise

    def free(self):
        """Stop the loop and drop the program's state (its caches); the
        weights and inputs stay for the reference."""
        self.loop.shutdown()
        self.loop = self.proxy = self.batcher = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def streamed(pending) -> list:
    """The tokens a stream carried before its "done" item."""
    toks = []
    while pending.tokens is not None and not pending.tokens.empty():
        kind, payload = pending.tokens.get_nowait()
        if kind == "tokens":
            toks.extend(payload)
    return toks


def collect(serving: Serving, pending: list, submitted: list, due: list,
            window: tuple, deadline: float) -> types.SimpleNamespace:
    """Wait for every submitted request (until `deadline`), then the
    per-request record: due, submitted, admitted (its wave's start), clock,
    first_token, finish (perf_counter seconds), served tokens, prompt
    length, grid, budget, error, and whether its stream matched."""
    for p in pending:
        p.event.wait(max(0.0, deadline - time.perf_counter()))
    snap = serving.proxy.snapshot()
    index = {p: i for i, p in enumerate(pending)}
    waves = [(t0, t1, [index[tag] for tag, _slot in adm if tag in index],
              clock) for t0, t1, adm, clock in snap["waves"]]
    reqs = []
    for i, p in enumerate(pending):
        inp, shape = serving.inputs[i], serving.shapes[i]
        fin = snap["finished"].get(p)
        served = None if fin is None else fin[1].sequences[:fin[1].length].copy()
        adm = snap["admitted"].get(p)
        stream_ok = True
        if served is not None and p.tokens is not None:
            got = streamed(p)
            stream_ok = got == served[:len(got)].tolist()
        reqs.append(types.SimpleNamespace(
            index=i, due=due[i], submitted=submitted[i],
            admitted=None if adm is None else adm[0],
            clock=None if adm is None else adm[1],
            first_token=snap["first_token"].get(p),
            finish=None if fin is None else fin[0], served=served,
            prompt_len=len(inp["ids"]), grid=inp["grid"],
            budget=shape["max_new_tokens"], error=p.error, stream_ok=stream_ok))
    return types.SimpleNamespace(requests=reqs, window=window, waves=waves,
                                 spans=snap["spans"], chunks=snap["chunks"])


def finish_record(cell, serving: Serving, run, seed: int, setup_s: float,
                  seconds: float, tracer) -> types.SimpleNamespace:
    """After the drain: the device's peak (before the reference runs), the
    trace's summary, the program's state freed, then the outputs checked.
    -> the record the metric readers and the result line take."""
    cuda = serving.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(serving.device) if cuda else 0
    log(f"drained; peak {peak / 2**30:.2f} GiB")
    serving.free()
    checks, facts = check.served_model(cell, serving, run, seed)
    log(f"checked: {checks} {facts}")
    reqs = run.requests
    return types.SimpleNamespace(
        cell=cell, config=cell.config, serving=cell.traffic["serving"],
        setup_s=setup_s, seconds=seconds, window=run.window, requests=reqs,
        waves=run.waves, chunks=run.chunks, spans=run.spans,
        trace=None if tracer is None else tracer.summary(run.spans),
        memory_peak_bytes=peak, checks=checks, facts=facts,
        correct=check.passed(checks), attempted=len(reqs),
        failed=sum(r.error is not None for r in reqs))
