"""Token sampling, the vision prologue, and the grouped rollout sampler
(counterpart of spacer_tpu/sampler/sampler.py).

`Sampler.generate` is the trainer's rollout: prefill once per prompt (K1),
then decode the G completions of every prompt with the prompt's KV SHARED
across the group and a per-completion tail cache, through K2
(ops/flash_decode.flash_decode_attention) on every layer of every step.
Caches are head-major: prefix (B, Hkv, P, Dh), tails (B*G, Hkv, T, Dh).

`decode_quant` quantizes the decode loop only (the prefill and the first
token stay in the params' dtype), once per generate call because the params
change every optimizer step: "int8" / "int4" quantize the layer weights and
an untied lm_head (ops/quant.py; int4 through K6), "int8_kv" / "int4_kv"
also hold the prefix and tail caches as int8 codes with per-(position,
head) f32 scales, attended through K2-int8.
The JAX loop is a lax.while_loop over doubling tail buckets (a static-shape
artefact); here the tails are allocated at max_new_tokens, the live length
is a host int (K2 reads only live tail chunks), and the all-done early exit
is checked on the host every few steps (the extra steps only write EOS,
and the tokens past the JAX exit point are reset to 0 afterwards).

`speculate_k` > 0 replaces the sequential decode with the speculative
block loop (sampler/speculating.py: prompt-lookup drafts, greedy at
temperature 0, exact rejection sampling otherwise); SampleOutput.stats then
holds its acceptance.

Random draws come from a torch.Generator; they differ from jax.random's for
the same seed, so only the distribution (`filtered_logits`) and greedy
decoding (temperature 0) are comparable across the two packages.  A
sample is the exponential race torch.multinomial runs for one draw
(argmax of probs / Exp(1) noise), with the noise drawn for the WHOLE
batch even where a rank decodes some of its rows: each row then gets the
draws it gets in a single process, whatever the sharding (JAX's draws do
not depend on the sharding either).

With a device mesh (parallel/mesh.py) every rank calls `generate` with the
same global batch.  The prompt rows split over data x fsdp when they
divide, else over data, else every rank decodes them all (JAX's
`_rollout_spec`); the params' fsdp Shards are gathered once for the
rollout and dropped when it ends, and every rank returns every row.  The
MoE is told how the rows lie (parallel/expert.rows), and with the experts
placed by expert (moe_impl "ep") over split rows the batch group agrees on
the all-done exit (parallel/expert.all_done), since a rank that left
would stop issuing its expert exchanges.  The speculative block loop runs
over split rows too: every rank steps until every rank's rows are done,
with one process's tail buckets and random draws, and its acceptance
counts are summed over the ranks (sampler/speculating.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spacer_tpu_torch.models.qwen25_vl.language import (
    init_kv_cache,
    lm_decode_step_split,
    lm_forward,
)
from spacer_tpu_torch.models.qwen25_vl.model import (
    encode_vision,
    merge_vision_embeds,
)
from spacer_tpu_torch.nn.core import embed
from spacer_tpu_torch.ops.quant import quantize_decode_model, quantize_kv
from spacer_tpu_torch.parallel import expert

MASK_VALUE = -1e30
DECODE_QUANTS = (None, "int8", "int8_kv", "int4", "int4_kv")
# host check of the all-done early exit every this many decode steps
DONE_CHECK_EVERY = 8


@dataclasses.dataclass
class SampleOutput:
    sequences: np.ndarray        # (B*G, max_new) sampled token ids
    completion_mask: np.ndarray  # (B*G, max_new) 1 up to & including first EOS
    lengths: np.ndarray          # (B*G,) completion lengths (mask sums)
    stats: Optional[dict] = None


def _topp_threshold_bisect(logits, lse, top_p, iters: int = 24):
    """Per-row nucleus threshold by bisection: the largest t such that
    P(logit >= t) >= top_p.  The masked sums read bf16 copies of the logits
    and probabilities with f32 accumulation, as the JAX version does."""
    probs_b = torch.exp(logits - lse).to(torch.bfloat16)
    logits_b = logits.to(torch.bfloat16)
    lo = logits.amin(dim=-1, keepdim=True)
    hi = logits.amax(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=torch.bfloat16, device=logits.device)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.where(logits_b >= mid.to(torch.bfloat16), probs_b,
                           zero).sum(dim=-1, keepdim=True, dtype=torch.float32)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def filtered_logits(logits, temperature: float, top_p: float):
    """Temperature-scaled, nucleus-filtered f32 logits: the distribution
    sample_logits draws from (softmax of this)."""
    logits = logits.float() / temperature
    if top_p is not None and top_p < 1.0:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        kept_min = _topp_threshold_bisect(logits, lse, top_p)
        keep = logits.to(torch.bfloat16) >= kept_min.to(torch.bfloat16)
        logits = torch.where(keep, logits,
                             torch.tensor(float("-inf"), device=logits.device))
    return logits


def sample_logits(logits, generator: torch.Generator | None,
                  temperature: float, top_p: float, rows=None):
    """(B, V) logits -> (B,) token ids; greedy argmax at temperature <= 0.
    A draw is torch.multinomial's for one sample (the same tokens): argmax
    of probs / q with q ~ Exp(1).  `rows` = (n, lo): these B rows are rows
    [lo, lo + B) of a batch of n, and q is drawn for all n rows."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filtered_logits(logits, temperature, top_p), dim=-1)
    n, lo = rows if rows is not None else (probs.shape[0], 0)
    q = torch.empty((n, probs.shape[1]), dtype=probs.dtype,
                    device=probs.device).exponential_(1, generator=generator)
    if n != probs.shape[0]:
        q = q[lo:lo + probs.shape[0]]
    return torch.argmax(probs / q, dim=-1)


def prologue(params, ids, pixel_values, *, cfg, grid_thw):
    """Embed, then vision-encode, then merge the vision embeddings over the
    placeholder tokens (pixel_values None for a text-only prompt)."""
    token_embeds = embed(params["model"]["embed_tokens"], ids)
    if pixel_values is None:
        return token_embeds
    ve = encode_vision(params, cfg, pixel_values, grid_thw)
    return merge_vision_embeds(cfg, ids, token_embeds, ve)


def completion_mask_from_ids(completion_ids: np.ndarray, eos_token_id: int
                             ) -> np.ndarray:
    """Mask = positions up to and including the first EOS."""
    is_eos = completion_ids == eos_token_id
    n, L = is_eos.shape
    eos_idx = np.full((n,), L, dtype=np.int64)
    any_eos = is_eos.any(axis=1)
    eos_idx[any_eos] = is_eos.argmax(axis=1)[any_eos]
    seq = np.arange(L)[None, :]
    return (seq <= eos_idx[:, None]).astype(np.int32)


def _prep_decode(model, prefix_cache, n_rows: int, max_new_tokens: int,
                 decode_quant=None):
    """The decode loop's state, once per generate call (spacer_tpu's
    _prep_decode, head-major): -> (model params for decode, per-layer
    prefix entries, per-layer tail entries).

    The prefill cache {"k","v": [(B, P, Hkv, Dh)] per layer} becomes
    head-major (B, Hkv, P, Dh) prefix entries; tails (n_rows, Hkv,
    max_new_tokens, Dh) start at zero.  decode_quant quantizes the layer
    weights and an untied lm_head ("int8*" / "int4*"); "*_kv" makes every
    entry a 4-tuple of int8 codes and f32 scales (..., P) / (..., T)."""
    model = quantize_decode_model(model, decode_quant)
    prefix = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
              for k, v in zip(prefix_cache["k"], prefix_cache["v"])]
    pk0 = prefix[0][0]
    tshape = (n_rows, pk0.shape[1], max_new_tokens, pk0.shape[3])

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=pk0.device)

    if decode_quant in ("int8_kv", "int4_kv"):
        def quant_entry(k, v):
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            return kq, vq, ks, vs

        prefix = [quant_entry(k, v) for k, v in prefix]
        tails = [(zeros(tshape, torch.int8), zeros(tshape, torch.int8),
                  zeros(tshape[:-1], torch.float32),
                  zeros(tshape[:-1], torch.float32)) for _ in prefix]
    else:
        tails = [(zeros(tshape, pk0.dtype), zeros(tshape, pk0.dtype))
                 for _ in prefix]
    return model, prefix, tails


def _decode_loop(model, text_cfg, prefix_split, tails, prefix_mask,
                 first_tokens, deltas, prompt_len: int, group: int,
                 max_new_tokens: int, temperature: float, top_p: float,
                 eos_token_id: int, generator, rows=None,
                 lockstep=None) -> torch.Tensor:
    """Shared-prefix autoregressive loop -> tokens (B*G, max_new); `rows`
    as sample_logits takes it.  `lockstep`: the mesh whose batch group
    must leave the loop together (expert-parallel exchanges over rows the
    ranks split), or None (this rank's rows decide)."""
    N = first_tokens.shape[0]
    dev = first_tokens.device
    bias_p = torch.where(prefix_mask, 0.0, MASK_VALUE)[:, None, :].float()
    bias_p = bias_p.contiguous()
    tokens = torch.zeros((N, max_new_tokens), dtype=torch.long, device=dev)
    tokens[:, 0] = first_tokens
    done = first_tokens == eos_token_id
    eos = torch.full_like(first_tokens, eos_token_id)
    for step in range(1, max_new_tokens):
        if step % DONE_CHECK_EVERY == 1 and (
                expert.all_done(done, lockstep) if lockstep is not None
                else bool(done.all())):
            break
        cur = tokens[:, step - 1:step]
        pos = (prompt_len + deltas + step - 1).reshape(1, N, 1).expand(3, N, 1)
        logits = lm_decode_step_split(
            model["layers"], model, text_cfg, cur, pos, prefix_split, bias_p,
            tails, tail_index=step - 1, group=group, tail_len=step)
        nxt = sample_logits(logits[:, -1], generator, temperature, top_p,
                            rows)
        nxt = torch.where(done, eos, nxt)
        tokens[:, step] = nxt
        done = done | (nxt == eos_token_id)
    return tokens


def _jax_exit_point(tokens: np.ndarray, eos_token_id: int) -> np.ndarray:
    """EOS after each row's first EOS, then zero the positions the JAX loop
    never writes: it stops before step s once every row has an EOS in
    tokens[:, :s].  (A loop over some of the rows may stop before the
    others' end; this is the same result for any split of the rows.)"""
    is_eos = tokens == eos_token_id
    after = np.cumsum(is_eos, axis=1) > 0
    if (after & ~is_eos).any():
        tokens = np.where(after, eos_token_id, tokens)
    if is_eos.any(axis=1).all():
        stop = int(is_eos.argmax(axis=1).max()) + 1
        tokens = tokens.copy()
        tokens[:, stop:] = 0
    return tokens


def _generate(params, text_cfg, input_embeds, position_ids, prompt_mask,
              deltas, generator, *, num_generations: int,
              max_new_tokens: int, temperature: float, top_p: float,
              eos_token_id: int, decode_quant=None, speculate_k: int = 0,
              input_ids=None, pad_token_id: int = 0, rows=None,
              layout=expert.EVERY_RANK, lockstep=None, split=None):
    """Prefill once per prompt (B rows), then the grouped decode loop (its
    quantized weights and caches are dropped when it returns) -> tokens
    (B*G, max_new), or with speculate_k (drafting from input_ids) the
    speculative loop's (tokens, [row-steps, emitted tokens]).
    input_embeds: (B, S, D) left-padded; `rows` = (n, lo): the B*G
    completion rows are rows [lo, lo + B*G) of n (sample_logits);
    `layout`: the prompt rows' parallel.expert.RowLayout; `lockstep` as
    _decode_loop takes it; `split` = (mesh, axes) of rows split across
    ranks, or None (spec_decode_loop)."""
    B, S, _ = input_embeds.shape
    G = num_generations
    cache = init_kv_cache(text_cfg, B, S, dtype=input_embeds.dtype,
                          device=input_embeds.device)
    with expert.rows(layout):
        logits, cache = lm_forward(
            params["model"], text_cfg, input_embeds=input_embeds,
            position_ids=position_ids, kv_mask=prompt_mask, cache=cache,
            cache_index=0, last_only=True)
    last = logits[:, -1].repeat_interleave(G, dim=0)        # (B*G, V)
    deltas = deltas.reshape(-1).repeat_interleave(G)
    first = sample_logits(last, generator, temperature, top_p, rows)
    model, prefix, tails = _prep_decode(params["model"], cache, B * G,
                                        max_new_tokens, decode_quant)
    del cache
    with expert.rows(expert.expand_layout(layout, G)):
        if speculate_k:
            from spacer_tpu_torch.sampler.speculating import spec_decode_loop

            return spec_decode_loop(
                model, text_cfg, prefix, prompt_mask, tails, first, input_ids,
                deltas, S, G, max_new_tokens, temperature, top_p,
                eos_token_id, pad_token_id, speculate_k, generator, rows,
                split)
        return _decode_loop(model, text_cfg, prefix, tails, prompt_mask,
                            first, deltas, S, G, max_new_tokens, temperature,
                            top_p, eos_token_id, generator, rows, lockstep)


class Sampler:
    """Padding/bucketing around the grouped rollout (spacer_tpu's Sampler).

    `decode_quant` is one of DECODE_QUANTS (other values raise ValueError).
    `speculate_k` > 0 (a negative value raises ValueError) decodes with the
    speculative block loop; generate(speculate_k=...) overrides it per
    call.  `mesh`: the port's parallel.mesh.Mesh (anything else raises
    TypeError; a tp the family's heads or widths do not divide,
    ValueError), see the module docstring.  Sequential
    decode is head-major through K2 / K2-int8 (the kernels on CUDA, their
    plain versions on the CPU)."""

    def __init__(self, cfg, eos_token_id: int | None = None,
                 pad_token_id: int | None = None, length_bucket: int = 128,
                 decode_quant: str | None = None,
                 speculate_k: int | None = None, mesh=None):
        from spacer_tpu_torch.models.registry import family_for_config

        if decode_quant not in DECODE_QUANTS:
            raise ValueError(
                f"unknown decode_quant {decode_quant!r} "
                "(expected None, 'int8', 'int8_kv', 'int4' or 'int4_kv')")
        self.speculate_k = int(speculate_k or 0)
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        from spacer_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a spacer_tpu_torch.parallel.mesh."
                            f"Mesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.cfg = cfg
        self.family = family_for_config(cfg)
        if mesh is not None:
            # a tp the family's heads or widths do not divide raises
            self.family.tp_plan(cfg, mesh.shape["tp"])
        self.eos_token_id = (eos_token_id if eos_token_id is not None
                             else cfg.eos_token_id)
        self.pad_token_id = (pad_token_id if pad_token_id is not None
                             else cfg.pad_token_id)
        self.length_bucket = length_bucket
        self.decode_quant = decode_quant

    def _bucket(self, n: int) -> int:
        b = self.length_bucket
        return max(b, -(-n // b) * b)

    def _rollout_axes(self, n: int) -> tuple:
        """The batch axes the n prompt rows split over: data x fsdp where
        they divide, then data, then none (JAX's _rollout_spec)."""
        if self.mesh is None:
            return ()
        shape = self.mesh.shape
        for axes in (("data", "fsdp"), ("data",)):
            k = int(np.prod([shape[a] for a in axes]))
            if k > 1 and n % k == 0:
                return axes
        return ()

    def _local_prompts(self, n: int, axes) -> tuple[int, int]:
        if not axes:
            return 0, n
        idx = (self.mesh.batch_index if axes == ("data", "fsdp")
               else self.mesh.coords["data"])
        per = n // int(np.prod([self.mesh.shape[a] for a in axes]))
        return idx * per, (idx + 1) * per

    @torch.no_grad()
    def generate(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                 params, *, position_ids: np.ndarray, deltas: np.ndarray,
                 pixel_values=None, grid_thw=None,
                 vision_kwargs: dict | None = None, vision_embeds=None,
                 num_generations: int = 1,
                 max_new_tokens: int = 1024, temperature: float = 1.0,
                 top_p: float = 0.95, seed: int = 0,
                 speculate_k: int | None = None) -> SampleOutput:
        """Sample `num_generations` completions per prompt -> SampleOutput.
        The prompts' vision inputs come as `vision_kwargs` (or Qwen's
        `pixel_values` + `grid_thw`), encoded here, or as precomputed
        `vision_embeds` (N, D) merged as they are: a single-process path
        (ValueError under a mesh)."""
        cfg = self.cfg
        if vision_embeds is not None and self.mesh is not None:
            raise ValueError(
                "vision_embeds pass-through is a single-process path; "
                "multi-process callers pass vision_kwargs")
        input_ids = np.asarray(input_ids)
        if int(np.max(input_ids)) >= cfg.text.vocab_size:
            raise ValueError(f"input_ids contain id {int(np.max(input_ids))} "
                             f">= vocab_size {cfg.text.vocab_size}")
        attention_mask = np.asarray(attention_mask)
        position_ids = np.asarray(position_ids)
        B, S = input_ids.shape
        pad = self._bucket(S) - S
        if pad:
            # extend left padding; positions for pad slots are irrelevant
            input_ids = np.concatenate(
                [np.full((B, pad), self.pad_token_id, input_ids.dtype),
                 input_ids], axis=1)
            attention_mask = np.concatenate(
                [np.zeros((B, pad), attention_mask.dtype), attention_mask], 1)
            position_ids = np.concatenate(
                [np.ones((3, B, pad), position_ids.dtype), position_ids], 2)
            # delta = max_pos + 1 - seq_len; padding grows seq_len
            deltas = np.asarray(deltas) - pad

        spec_k = self.speculate_k if speculate_k is None else int(speculate_k)
        if spec_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        axes = self._rollout_axes(B)
        from spacer_tpu_torch.parallel.fsdp import gather_params

        # fsdp Shards gathered once for the whole rollout, dropped after it
        params = gather_params(params)
        emb = params["model"]["embed_tokens"]["embedding"]
        dev = emb.device

        def tensor(a, dtype=torch.long):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        ids = tensor(input_ids)
        if vision_kwargs is None and pixel_values is not None:
            vision_kwargs = {"pixel_values": pixel_values}
        embeds = embed(params["model"]["embed_tokens"], ids)
        if vision_embeds is not None:
            embeds = self.family.merge_vision_embeds(
                cfg, ids, embeds, torch.as_tensor(vision_embeds, device=dev))
        elif vision_kwargs:
            ve = self.family.encode_vision(params, cfg, vision_kwargs,
                                           grid_thw)
            embeds = self.family.merge_vision_embeds(cfg, ids, embeds, ve)
        lo, hi = self._local_prompts(B, axes)
        # the MoE's rows (parallel/expert.py): every rank of the batch group
        # must also leave the decode loop together where they hold
        # different rows and share expert exchanges
        layout = expert.split_layout(B, self.mesh, axes)
        lockstep = (self.mesh if axes and expert.has_placed(params)
                    else None)
        G = num_generations
        rows = (B * G, lo * G) if axes else None
        sl = slice(lo, hi)
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        temp = float(temperature) if temperature is not None else 0.0
        topp = float(top_p) if top_p is not None else 1.0
        out = _generate(
            params, cfg.text, embeds[sl], tensor(position_ids[:, sl]),
            tensor(attention_mask[sl], torch.bool), tensor(deltas[sl]),
            generator, num_generations=G, max_new_tokens=max_new_tokens,
            temperature=temp, top_p=topp, eos_token_id=self.eos_token_id,
            decode_quant=self.decode_quant, speculate_k=spec_k,
            input_ids=ids[sl], pad_token_id=self.pad_token_id, rows=rows,
            layout=layout, lockstep=lockstep,
            split=(self.mesh, axes) if axes else None)
        del params, emb, embeds
        stats = None
        if spec_k:
            out, (steps, emitted) = out[0], out[1].tolist()
            stats = {"spec_row_steps": steps, "spec_tokens": emitted,
                     "spec_acceptance": emitted / max(steps, 1)}
        if axes:
            from spacer_tpu_torch.parallel.multihost import fetch_to_host

            tokens = fetch_to_host(out, self.mesh, axes)
        else:
            tokens = out.cpu().numpy()
        if not spec_k:
            tokens = _jax_exit_point(tokens, self.eos_token_id)
        mask = completion_mask_from_ids(tokens, self.eos_token_id)
        return SampleOutput(sequences=tokens, completion_mask=mask,
                            lengths=mask.sum(axis=1), stats=stats)
