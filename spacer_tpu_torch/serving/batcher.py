"""Continuous batching: cross-request serving with slot refill (counterpart
of spacer_tpu/serving/batcher.py).

    host                                  device
    ----                                  ------
    queue of requests      --admit-->     prefill (K1) + KV copy into slot r
    every chunk_steps steps <--poll--     done flags / emitted counts
    finished slot harvested --admit-->    next request refills the slot

Decode runs in chunks of up to `chunk_steps` clock-ring steps
(serving/ragged.py, K5 attention), leaving a chunk early once every slot is
done.  Slots admitted at different times sit at different depths; the
per-slot prefix caches and the shared-clock completion ring are updated in
place.

`decode_quant` (None, "int8", "int8_kv", "int4", "int4_kv") quantizes the
layer weights and an untied lm_head for the decode chunks only, once per
batcher (ops/quant.py; int4 through K6); the admission prefill stays in the
params' dtype.  "*_kv" holds the prefix and ring caches as int8 codes with
(R, Hkv, T) f32 scales (attention through K5-int8); admission quantizes
each slot's prefix.

`speculate_k` > 0 replaces the clock-ring steps with prompt-lookup
speculative block steps (serving/speculative.py): a positional tail in the
same caches, kb = 1 + speculate_k tokens verified per slot and step, greedy
at temperature 0 and exact rejection sampling otherwise; admission is
shared.  `spec_stats` counts the active row-steps and the tokens they
emitted.

Program spans (utils/profiling.py; no-ops unless recording):
`batcher.admit` holds `admit.host` (padding, the host arrays and their
copies to the device), `admit.vit`, `admit.prefill`, `admit.slot_copy` and
`admit.first_token`, each synchronized at its end while recording, with
counters `admit.positions` (bucket x prompts) and `admit.real_positions`.
`batcher.decode_chunk` holds one `decode.step` per step, of `decode.launch`
(the step's enqueue) and `decode.done_check` (the host's wait on the done
flags, which waits for the step's device work); counters `decode.steps` and
`decode.slots_held` (assigned slots, summed over steps).  `host_syncs`
counts every blocking device-to-host read and pageable host-to-device copy
of the serving path where it happens.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from spacer_tpu_torch.models.qwen25_vl.language import (
    init_kv_cache,
    lm_forward,
    local_kv_heads,
)
from spacer_tpu_torch.nn.core import embed
from spacer_tpu_torch.ops.quant import quantize_decode_model, quantize_kv
from spacer_tpu_torch.sampler.sampler import (
    DECODE_QUANTS,
    completion_mask_from_ids,
    prologue,
    sample_logits,
)
from spacer_tpu_torch.parallel import expert
from spacer_tpu_torch.serving.ragged import ragged_decode_step
from spacer_tpu_torch.serving.speculative import spec_chunk
from spacer_tpu_torch.utils import profiling


@dataclasses.dataclass
class ServedOutput:
    sequences: np.ndarray   # (Cmax,) token ids (garbage past length)
    length: int             # emitted tokens incl. the first EOS


class ContinuousBatcher:
    """Slot-based continuous batching over the clock-ring decode step.

    run() drives a request list to completion.  All requests share one
    geometry (prompt_len bucket, max completion length).  The device and
    dtype are the params' own."""

    def __init__(self, cfg, params, *, slots: int = 8, prompt_len: int = 512,
                 max_new_tokens: int = 128, eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None, temperature: float = 0.0,
                 top_p: float = 1.0, decode_quant: Optional[str] = None,
                 speculate_k: int = 0, chunk_steps: int = 32, seed: int = 0):
        if decode_quant not in DECODE_QUANTS:
            raise ValueError(
                f"unknown decode_quant {decode_quant!r} "
                "(expected None, 'int8', 'int8_kv', 'int4' or 'int4_kv')")
        self.speculate_k = int(speculate_k)
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        self.cfg = cfg
        self.params = params
        # the decode chunks' params (quantized once per batcher); the
        # admission prefill reads params["model"]
        self.decode_model = quantize_decode_model(params["model"], decode_quant)
        self.R, self.Pmax, self.Cmax = slots, prompt_len, max_new_tokens
        self.eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        self.pad = pad_token_id if pad_token_id is not None else cfg.pad_token_id
        self.temperature = float(temperature) if temperature else 0.0
        self.top_p = float(top_p) if top_p is not None else 1.0
        self.chunk_steps = chunk_steps
        emb = params["model"]["embed_tokens"]["embedding"]
        self.device, self.dtype = emb.device, emb.dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        tc = cfg.text
        hkv = local_kv_heads(tc)      # this rank's KV heads under tp
        pshape = (self.R, hkv, self.Pmax, tc.head_dim)
        tshape = (self.R, hkv, self.Cmax, tc.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if decode_quant in ("int8_kv", "int4_kv"):
            i8, f32 = torch.int8, torch.float32
            self.caches = [(zeros(pshape, i8), zeros(pshape, i8),
                            zeros(tshape, i8), zeros(tshape, i8),
                            zeros(pshape[:-1], f32), zeros(pshape[:-1], f32),
                            zeros(tshape[:-1], f32), zeros(tshape[:-1], f32))
                           for _ in range(tc.num_layers)]
        else:
            self.caches = [(zeros(pshape, self.dtype), zeros(pshape, self.dtype),
                            zeros(tshape, self.dtype), zeros(tshape, self.dtype))
                           for _ in range(tc.num_layers)]
        i64 = torch.int64
        self.pmask = zeros((self.R, self.Pmax), torch.bool)
        self.pids = zeros((self.R, self.Pmax), i64)   # drafting context
        self.delta = zeros((self.R,), i64)
        self.admit_clock = zeros((self.R,), i64)
        self.cur = zeros((self.R,), i64)
        self.t = zeros((self.R,), i64)
        self.done = torch.ones((self.R,), dtype=torch.bool, device=self.device)
        self.maxnew = zeros((self.R,), i64)
        self.out = zeros((self.R, self.Cmax), i64)
        self.clock = 0
        # [speculative row-steps run, tokens emitted by them]
        self.spec = zeros((2,), i64)
        self._slot_req: list = [None] * self.R

    # -- request normalization ------------------------------------------

    def _pad_request(self, req: dict):
        """Left-pad a single-prompt request to the Pmax bucket."""
        ids = np.asarray(req["input_ids"])
        mask = np.asarray(req["attention_mask"])
        pos = np.asarray(req["position_ids"])
        delta = int(np.asarray(req.get("deltas", 0)).reshape(-1)[0])
        if ids.shape[0] != 1:
            raise ValueError("one prompt per request")
        if int(ids.max()) >= self.cfg.text.vocab_size:
            raise ValueError(f"input_ids contain id {int(ids.max())} >= "
                             f"vocab_size {self.cfg.text.vocab_size}")
        S = ids.shape[1]
        if S > self.Pmax:
            raise ValueError(f"prompt len {S} exceeds bucket {self.Pmax}")
        pad = self.Pmax - S
        if pad:
            ids = np.concatenate([np.full((1, pad), self.pad, ids.dtype), ids], 1)
            mask = np.concatenate([np.zeros((1, pad), mask.dtype), mask], 1)
            pos = np.concatenate([np.ones((3, 1, pad), pos.dtype), pos], 2)
            delta -= pad
        return ids, mask, pos, delta

    def validate_request(self, req: dict) -> None:
        """Host-side validation of one request (prompt shape, vocabulary
        range, bucket fit): raises ValueError without touching device
        state, so the online ServingLoop can fail a malformed request
        alone at submit time."""
        self._pad_request(req)

    def _admit_wave(self, admissions: list):
        """Admit [(req, budget, slot), ...] with one prefill.  Identical
        prompts in the wave prefill once and fan their KV out to every clone
        slot (text prompts dedupe by tokens, vision prompts by the identity
        of their vision_kwargs)."""
        uniq_index, uniq, src = {}, [], []
        for req, _budget, _slot in admissions:
            vk = req.get("vision_kwargs") or None
            key = (np.asarray(req["input_ids"]).tobytes(),
                   np.asarray(req["attention_mask"]).tobytes(),
                   id(vk) if vk is not None else None)
            if key not in uniq_index:
                uniq_index[key] = len(uniq)
                uniq.append(req)
            src.append(uniq_index[key])

        dev = self.device
        ids_l, mask_l, pos_l, deltas_u, embeds_l = [], [], [], [], []
        any_vision = any(r.get("vision_kwargs") for r in uniq)
        for req in uniq:
            with profiling.span("admit.host", sync=True):
                ids, mask, pos, delta = self._pad_request(req)
                if any_vision:
                    px = (req.get("vision_kwargs") or {}).get("pixel_values")
                    if px is not None:
                        profiling.count("host_syncs")
                        px = torch.as_tensor(px, device=dev).to(self.dtype)
                    profiling.count("host_syncs")
                    ids_t = torch.as_tensor(ids, device=dev).long()
            if any_vision:
                with profiling.span("admit.vit", sync=True):
                    embeds_l.append(prologue(
                        self.params, ids_t, px, cfg=self.cfg,
                        grid_thw=req.get("grid_thw")).to(self.dtype))
            ids_l.append(ids)
            mask_l.append(mask)
            pos_l.append(pos)
            deltas_u.append(delta)
        if profiling.enabled():
            bucket = ids_l[0].shape[1]
            profiling.count("admit.positions", bucket * len(src))
            profiling.count("admit.real_positions",
                            sum(int(mask_l[u].sum()) for u in src))

        def tensor(a, dtype=torch.int64):
            profiling.count("host_syncs")
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        with profiling.span("admit.host", sync=True):
            args = (tensor(np.concatenate(ids_l, 0)),
                    torch.cat(embeds_l) if any_vision else None,
                    tensor(np.concatenate(pos_l, 1)),
                    tensor(np.concatenate(mask_l, 0), torch.bool),
                    tensor([deltas_u[s] for s in src]),
                    tensor([b for _r, b, _s in admissions]))
        self._admit(*args, [s for _r, _b, s in admissions], src)

    def _admit(self, input_ids, input_embeds, position_ids, prompt_mask,
               delta, max_new, slots: list, src: list):
        """Prefill Bu unique prompts and insert them into len(slots) slots."""
        with profiling.span("admit.prefill", sync=True):
            if input_embeds is None:
                input_embeds = embed(self.params["model"]["embed_tokens"],
                                     input_ids)
            Bu, S, _ = input_embeds.shape
            cache = init_kv_cache(self.cfg.text, Bu, S, self.dtype, self.device)
            with expert.rows(expert.EVERY_RANK):
                logits, cache = lm_forward(
                    self.params["model"], self.cfg.text,
                    input_embeds=input_embeds, position_ids=position_ids,
                    kv_mask=prompt_mask, cache=cache, cache_index=0,
                    last_only=True)
        # (Bu, Pmax, Hkv, Dh) prefill cache -> head-major slot rows, in
        # place (int8 caches: codes and scales, quantized per unique row)
        with profiling.span("admit.slot_copy", sync=True):
            for entry, ck, cv in zip(self.caches, cache["k"], cache["v"]):
                rows = [ck.transpose(1, 2), cv.transpose(1, 2)]
                if len(entry) == 8:
                    (kq, ks), (vq, vs) = (quantize_kv(rows[0]),
                                          quantize_kv(rows[1]))
                    rows = [kq, vq, None, None, ks, vs]
                for slot, u in zip(slots, src):
                    for dst, rows_j in zip(entry, rows):
                        if rows_j is not None:
                            dst[slot].copy_(rows_j[u])

        with profiling.span("admit.first_token", sync=True):
            # the two index copies, and the three writes of a Python number
            # below (index_put copies it to the card)
            profiling.count("host_syncs", 5)
            src_t = torch.as_tensor(src, device=self.device)
            slot_t = torch.as_tensor(slots, device=self.device)
            first = sample_logits(logits[:, -1][src_t], self.generator,
                                  self.temperature, self.top_p)
            self.pmask[slot_t] = prompt_mask[src_t]
            self.pids[slot_t] = input_ids[src_t]
            self.delta[slot_t] = delta
            self.admit_clock[slot_t] = self.clock
            self.cur[slot_t] = first
            self.t[slot_t] = 1
            self.done[slot_t] = (first == self.eos) | (max_new <= 1)
            self.maxnew[slot_t] = max_new
            self.out[slot_t] = 0
            self.out[slot_t, 0] = first

    # -- step primitives --------------------------------------------------

    def budget_of(self, req: dict, max_new: Optional[int] = None) -> int:
        return min(int(req.get("max_new_tokens", max_new or self.Cmax)),
                   self.Cmax)

    def free_slots(self) -> list[int]:
        return [r for r in range(self.R) if self._slot_req[r] is None]

    def has_active(self) -> bool:
        return any(i is not None for i in self._slot_req)

    def admit(self, admissions: list) -> None:
        """admissions: list of (tag, request, budget, slot)."""
        for tag, _req, _budget, slot in admissions:
            if self._slot_req[slot] is not None:
                raise ValueError(f"slot {slot} busy")
            self._slot_req[slot] = tag
        with profiling.span("batcher.admit"):
            self._admit_wave([(req, budget, slot)
                              for _tag, req, budget, slot in admissions])

    def decode_chunk(self) -> None:
        """Up to chunk_steps clock-ring steps (or speculative block steps
        with speculate_k); stops early once every slot is done (checked
        before each step, as the JAX while_loop does).  Every rank runs
        the same slots, so every rank stops alike (parallel/expert.py)."""
        with profiling.span("batcher.decode_chunk"), \
                expert.rows(expert.EVERY_RANK):
            steps = self._decode_chunk()
            if profiling.enabled():
                profiling.count("decode.steps", steps)
                profiling.count("decode.slots_held", steps * sum(
                    r is not None for r in self._slot_req))

    def _all_done(self) -> bool:
        """Whether every slot is done: a read of the device's done flags,
        which waits for the steps enqueued before it."""
        with profiling.span("decode.done_check"):
            profiling.count("host_syncs")
            return bool(self.done.all())

    def run_steps(self, step, chunk_steps: int) -> int:
        """Run step() up to chunk_steps times, each one a `decode.step`,
        while some slot is not done (checked before each step, as the JAX
        while_loop does; the check of the next step closes the one before,
        so each step's span holds the wait for its device work) -> the steps
        run."""
        done = self._all_done()
        for i in range(chunk_steps):
            if done:
                return i
            with profiling.span("decode.step"):
                with profiling.span("decode.launch"):
                    step()
                if i + 1 < chunk_steps:
                    done = self._all_done()
        return chunk_steps

    def _decode_chunk(self) -> int:
        if self.speculate_k:
            return spec_chunk(self, self.decode_model["layers"],
                              self.decode_model, self.cfg.text,
                              chunk_steps=self.chunk_steps,
                              speculate_k=self.speculate_k)
        R, Pmax, Cmax = self.R, self.Pmax, self.Cmax
        ring_iota = torch.arange(Cmax, device=self.device)
        rows = torch.arange(R, device=self.device)
        model = self.decode_model

        def step():
            # cur is token #(t-1): rope position Pmax + delta + t - 1; its KV
            # lands at ring index clock % Cmax, inside the row's window
            # (j - admit) mod Cmax < t
            pos = Pmax + self.delta + self.t - 1
            pos3 = pos[None, :, None].expand(3, R, 1)
            rel = torch.remainder(ring_iota[None, :] - self.admit_clock[:, None],
                                  Cmax)
            ring_mask = rel < self.t[:, None]
            logits = ragged_decode_step(
                model["layers"], model, self.cfg.text, self.cur, pos3,
                self.caches, self.clock % Cmax, self.pmask, ring_mask)
            nxt = sample_logits(logits, self.generator, self.temperature,
                                self.top_p)
            was_done = self.done
            tw = self.t.clamp(max=Cmax - 1)   # JAX's clamped update index
            self.out[rows, tw] = torch.where(was_done, self.out[rows, tw], nxt)
            self.t = torch.where(was_done, self.t, self.t + 1)
            self.done = was_done | (nxt == self.eos) | (self.t >= self.maxnew)
            self.cur = torch.where(was_done, self.cur, nxt)
            self.clock += 1

        return self.run_steps(step, self.chunk_steps)

    @property
    def spec_stats(self) -> dict:
        """{"steps", "tokens"} over speculative block row-steps (one active
        row in one block step, what a sequential decode spends to emit one
        token): tokens / steps is the mean acceptance including the bonus
        token; 1.0 means speculation never helped."""
        steps, tokens = self.spec.tolist()
        return {"steps": steps, "tokens": tokens}

    def poll_finished(self) -> list:
        """(tag, ServedOutput) for slots that finished; frees them."""
        profiling.count("host_syncs")
        done = self.done.cpu().numpy()
        finished = [r for r in range(self.R)
                    if self._slot_req[r] is not None and bool(done[r])]
        results = []
        if finished:
            profiling.count("host_syncs", 2)
            out = self.out.cpu().numpy()
            ts = self.t.cpu().numpy()
            for r in finished:
                seq = out[r].copy()   # on CPU, .numpy() shares the buffer
                cmask = completion_mask_from_ids(seq[None], self.eos)[0]
                length = int(min(cmask.sum(), ts[r]))
                results.append((self._slot_req[r],
                                ServedOutput(sequences=seq, length=length)))
                self._slot_req[r] = None
        return results

    def poll_progress(self) -> list:
        """(tag, token_row, t) for every active slot, the streaming feed:
        token_row[:t] are the emitted tokens (writes stop at done, so at
        most one trailing EOS).  Fetches the (R, Cmax) token buffer."""
        profiling.count("host_syncs", 2)
        ts = self.t.cpu().numpy()
        out = self.out.cpu().numpy().copy()
        return [(self._slot_req[r], out[r], int(ts[r]))
                for r in range(self.R) if self._slot_req[r] is not None]

    def run(self, requests: Sequence[dict],
            max_new_tokens: Optional[int] = None) -> list[ServedOutput]:
        """Drive all requests to completion; outputs in request order.
        Admission is longest-declared-budget first."""
        max_new = int(max_new_tokens or self.Cmax)
        if max_new > self.Cmax:
            raise ValueError(f"max_new {max_new} exceeds bucket {self.Cmax}")
        results: list = [None] * len(requests)
        order = sorted(range(len(requests)),
                       key=lambda i: -self.budget_of(requests[i], max_new))
        queue = deque((i, requests[i]) for i in order)
        while queue or self.has_active():
            admissions = []
            for slot in self.free_slots():
                if not queue:
                    break
                i, req = queue.popleft()
                admissions.append((i, req, self.budget_of(req, max_new), slot))
            if admissions:
                self.admit(admissions)
            self.decode_chunk()
            for i, served in self.poll_finished():
                results[i] = served
        return results
