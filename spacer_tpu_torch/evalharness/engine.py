"""Inference engines of the eval workers and the serving CLI (counterpart
of spacer_tpu/evalharness/engine.py).

QwenEngine.generate is the static path (one Sampler.generate per batch of
prompts: K1 prefill, K2 decode at one completion per prompt);
generate_many the continuous one (ContinuousBatcher: K1 prefill, K5
decode).  Request encoding (spacer_tpu/models/registry.py::encode_request)
is folded in here for the Qwen2.5-VL family: processor -> rope index -> one
serving request per conversation.  EchoEngine is a test double that answers
without weights.
"""

from __future__ import annotations

import numpy as np

from spacer_tpu_torch.data.processor import pack_vision_inputs
from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index
from spacer_tpu_torch.sampler.sampler import Sampler
from spacer_tpu_torch.serving.batcher import ContinuousBatcher


class QwenEngine:
    """Batched multimodal generation on the device that holds `params`.
    `decode_quant` (None, "int8", "int8_kv", "int4", "int4_kv") applies to
    the sampler and to every batcher; call k draws from seed + k."""

    def __init__(self, cfg, params, processor, length_bucket: int = 512,
                 top_p: float = 1.0, seed: int = 0,
                 decode_quant: str | None = None):
        self.cfg = cfg
        self.params = params
        self.processor = processor
        self.length_bucket = length_bucket
        self.top_p = top_p
        self.seed = seed
        self.decode_quant = decode_quant
        self._calls = 0
        self._batchers: dict = {}   # geometry key -> ContinuousBatcher
        self.sampler = Sampler(
            cfg, eos_token_id=processor.eos_token_id,
            pad_token_id=processor.pad_token_id, length_bucket=length_bucket,
            decode_quant=decode_quant)

    def encode_request(self, conversation: list) -> dict:
        """One conversation -> a serving request (input_ids, attention_mask,
        position_ids, deltas, grid_thw[, vision_kwargs])."""
        return self._encode([conversation])

    def _encode(self, messages_list) -> dict:
        """Conversations -> one left-padded batch: input_ids,
        attention_mask, M-RoPE position_ids and deltas, grid_thw and, where
        there are images or videos, vision_kwargs (pixels of both
        modalities in placeholder order)."""
        enc = self.processor.process_messages(list(messages_list),
                                              add_generation_prompt=True)
        pos, deltas = get_rope_index(
            self.cfg, enc["input_ids"],
            image_grid_thw=enc.get("image_grid_thw"),
            video_grid_thw=enc.get("video_grid_thw"),
            second_per_grid_ts=enc.get("second_per_grid_ts"),
            attention_mask=enc["attention_mask"],
        )
        pixel_values, grid_thw = pack_vision_inputs(enc)
        req = {"input_ids": enc["input_ids"],
               "attention_mask": enc["attention_mask"],
               "position_ids": pos, "deltas": deltas, "grid_thw": grid_thw}
        if pixel_values is not None:
            req["vision_kwargs"] = {"pixel_values": pixel_values}
        return req

    def generate(self, messages_list, *, max_new_tokens: int = 128,
                 temperature: float = 0.01) -> list[str]:
        """Static batched generation: all prompts in one Sampler.generate
        (left-padded to the length bucket), every row decoding until the
        longest finishes.  With decode_quant, the sampler quantizes the
        weights on every call, as the JAX sampler does."""
        req = self._encode(messages_list)
        self._calls += 1
        out = self.sampler.generate(
            req["input_ids"], req["attention_mask"], self.params,
            position_ids=req["position_ids"], deltas=req["deltas"],
            vision_kwargs=req.get("vision_kwargs"), grid_thw=req["grid_thw"],
            num_generations=1, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=self.top_p,
            seed=self.seed + self._calls)
        return self.processor.tokenizer.batch_decode(
            [seq[:n] for seq, n in zip(out.sequences, out.lengths)],
            skip_special_tokens=True,
        )

    def generate_many(self, messages_list, *, max_new_tokens: int = 128,
                      temperature: float = 0.01, slots: int = 4,
                      chunk_steps: int = 32) -> list[str]:
        """Continuous-batching generation: prompts stream through `slots`
        decode slots, finished rows refill at once.  Requests are bucketed
        by prompt length, one batcher geometry per bucket."""
        requests = [self.encode_request(m) for m in messages_list]
        bucket = self.length_bucket

        def pbucket(req):
            n = req["input_ids"].shape[1]
            return max(bucket, -(-n // bucket) * bucket)

        self._calls += 1
        results: list = [None] * len(requests)
        by_bucket: dict[int, list[int]] = {}
        for i, req in enumerate(requests):
            by_bucket.setdefault(pbucket(req), []).append(i)
        for Pmax, idxs in sorted(by_bucket.items()):
            batcher = self._get_batcher(Pmax, max_new_tokens, temperature,
                                        slots, chunk_steps)
            outs = batcher.run([requests[i] for i in idxs],
                               max_new_tokens=max_new_tokens)
            for i, o in zip(idxs, outs):
                results[i] = o
        return self.processor.tokenizer.batch_decode(
            [np.asarray(o.sequences[:o.length]) for o in results],
            skip_special_tokens=True,
        )

    def _get_batcher(self, Pmax: int, max_new: int, temperature: float,
                     slots: int, chunk_steps: int) -> ContinuousBatcher:
        """Cached per-geometry batcher (least recently used beyond 4 is
        dropped, bounding resident KV).  Cmax is bucketed up to 128s."""
        Cmax = max(128, -(-max_new // 128) * 128)
        key = (Pmax, Cmax, round(float(temperature), 6), slots, chunk_steps)
        if key in self._batchers:
            self._batchers[key] = self._batchers.pop(key)
        else:
            while len(self._batchers) >= 4:
                self._batchers.pop(next(iter(self._batchers)))
            self._batchers[key] = ContinuousBatcher(
                self.cfg, self.params, slots=slots, prompt_len=Pmax,
                max_new_tokens=Cmax,
                eos_token_id=self.processor.eos_token_id,
                pad_token_id=self.processor.pad_token_id,
                temperature=temperature, top_p=self.top_p,
                decode_quant=self.decode_quant, chunk_steps=chunk_steps,
                seed=self.seed + self._calls)
        return self._batchers[key]


class EchoEngine:
    """Deterministic test engine: returns canned or template answers."""

    def __init__(self, responder=None):
        self.responder = responder or (lambda messages: "<answer>A</answer>")
        self.calls: list = []

    def generate(self, messages_list, *, max_new_tokens: int = 128,
                 temperature: float = 0.01) -> list[str]:
        self.calls.append(len(messages_list))
        return [self.responder(m) for m in messages_list]
