"""SG-RLVR trainer: rollout -> rewards -> advantages -> update (counterpart
of spacer_tpu/train/trainer.py).

Behavioral reference: SG_RLVR_trainer.py compute_loss and the HF Trainer
loop around it.  As in the JAX trainer:
- the sampler shares params with the train step (no separate vLLM);
- vision is encoded once per prompt, not tiled xG;
- the temporal-shuffle prompts decode in the SAME grouped rollout as the
  main prompts (`merge_temporal_rollout`), keeping the first G/2 shuffled
  completions per video.

Rollouts decode at `decode_quant` (the JAX default "int8_kv": int8 weights
and int8 KV caches for the decode loop only; logps and updates stay in the
params' dtype; None gives bf16-exact rollouts).
`gradient_accumulation_steps = k > 1` wraps the optimizer as the JAX
trainer's optax.MultiSteps does (train/optimizer.py MultiSteps): each
`training_step` is one mini-step and every k-th applies the mean.
`offload_opt_state` keeps the moments and the accumulator in page-locked
host memory between updates (parallel/offload.py); the update streams them
through the card a moment group at a time.  `save_pretrained` writes an HF
layout (train/publish.py) and, with `push_to_hub`, uploads it.
`speculate_k` > 0 makes the rollouts speculative (sampler/speculating.py;
their acceptance is logged as spec_acceptance).  Configurations the port
does not run raise NotImplementedError at construction: any `attn_impl` /
`decode_impl` but None.

With a device mesh (parallel/mesh.py; one process per device under
torchrun) the params and ref params hold fsdp Shards and the optimizer
state is each rank's blocks.  `training_step` takes each rank's own rows:
every rank prepares (decodes the media of) its rows only, the encodings
are exchanged so that every rank holds the same global batch, the
rollout decodes each rank's share of the prompts (Sampler) and returns
every row everywhere, each rank scores the rewards of its own rows, the
rewards are exchanged, and the update runs each rank's rows of the global
batch (train/step.py).  `train()` hands each rank its contiguous share of
every chunk of `rollout_batch_size` rows (the GLOBAL prompts per step, as
in JAX on a multi-device mesh).  Only rank 0 writes metrics and
checkpoints; a failing step raises on every rank (one rank cannot skip a
step the others' collectives wait for).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from spacer_tpu_torch.models.registry import family_for_config
from spacer_tpu_torch.parallel import fsdp, multihost
from spacer_tpu_torch.sampler.sampler import SampleOutput, Sampler
from spacer_tpu_torch.train.grpo import (
    group_advantages,
    length_control_bonus,
    temporal_bonus,
)
from spacer_tpu_torch.train.optimizer import MultiSteps, make_optimizer
from spacer_tpu_torch.train.step import make_grpo_train_step, param_leaves
from spacer_tpu_torch.utils.logging import rank_logger


@dataclasses.dataclass
class SGRLVRConfig:
    """Training hyperparameters (defaults = run_SpaceR_SG_RLVR.sh and the
    JAX trainer's)."""

    num_generations: int = 8
    rollout_batch_size: int = 1
    max_prompt_length: int = 16384
    max_completion_length: int = 1024
    learning_rate: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 5.0
    beta: float = 0.04
    temperature: float = 1.0
    top_p: float = 0.95
    temporal: bool = True
    len_control: bool = True
    merge_temporal_rollout: bool = True
    num_train_epochs: int = 1
    max_steps: int | None = None
    gradient_accumulation_steps: int = 1
    logging_steps: int = 1
    save_steps: int = 1000
    save_only_model: bool = False
    skip_failed_steps: bool = True
    output_dir: str = "output"
    seed: int = 42
    min_pixels: int = 3136
    max_pixels: int = 401408
    prompt_bucket: int = 512
    offload_opt_state: bool = False
    # Adam moment storage: "int8" (default), "float32", "bfloat16"
    moment_dtype: str = "int8"
    # False | True | "dots" | "dots_narrow" | "dots_mixed:K" (check_remat)
    remat: Any = True
    logp_chunk: int = 256
    # attn_impl / decode_impl: the JAX trainer's fields, kept so its configs
    # parse; the port dispatches attention and decode by device, so only
    # None is accepted
    attn_impl: Optional[str] = None
    warmup_steps: int = 0
    # rollout decode quantization (sampler/sampler.py DECODE_QUANTS); the
    # JAX default, int8 weights + int8 KV caches in the decode loop
    decode_quant: Optional[str] = "int8_kv"
    decode_impl: Optional[str] = None
    push_to_hub: bool = False
    hub_model_id: str = ""
    # prompt-lookup speculative rollout decode (sampler/speculating.py):
    # kb = 1 + speculate_k tokens verified per block step; 0 = off
    speculate_k: int = 0


def _check_mesh(mesh, cfg=None):
    """A mesh must be the port's Mesh; its tp must divide the family's
    heads and widths (the family's tp plan raises ValueError)."""
    from spacer_tpu_torch.parallel.mesh import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a spacer_tpu_torch.parallel.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if mesh is not None and cfg is not None:
        family_for_config(cfg).tp_plan(cfg, mesh.shape["tp"])


def _unported(args, mesh, cfg=None):
    """The mesh's checks, and the JAX trainers' attn_impl / decode_impl
    fields (SGRLVRConfig; SFTConfig has no decode_impl) refused unless
    None."""
    _check_mesh(mesh, cfg)
    decode_impl = getattr(args, "decode_impl", None)
    if args.attn_impl is not None or decode_impl is not None:
        raise NotImplementedError(
            f"attn_impl={args.attn_impl!r} decode_impl={decode_impl!r}: "
            "the port has one attention path per device (the CUDA kernels on "
            "the card, their plain versions on the CPU); pass None")


class SGRLVRTrainer:
    """Trainer on the params' device; with a `mesh`, one rank of it (the
    module docstring)."""

    def __init__(self, cfg, params, processor,
                 reward_funcs: Sequence[Callable],
                 train_dataset: Sequence[dict], args: SGRLVRConfig, *,
                 map_data: dict | None = None, ref_params=None, mesh=None):
        _unported(args, mesh, cfg)
        self.cfg = cfg
        self.family = family_for_config(cfg)
        self.args = args
        self.processor = processor
        self.reward_funcs = list(reward_funcs)
        self.dataset = list(train_dataset)
        self.map_data = map_data
        self.mesh = mesh
        self.params = params
        # beta == 0 means no KL term: no reference copy is made (a copy of
        # sharded params is sharded alike)
        self.ref_params = (
            ref_params if ref_params is not None
            else None if args.beta == 0.0
            else _tree_map(_clone, params))
        steps_per_epoch = -(-len(self.dataset)
                            // max(1, args.rollout_batch_size))
        total = args.max_steps or (args.num_train_epochs * steps_per_epoch)
        self.tx = make_optimizer(
            learning_rate=args.learning_rate, total_steps=total,
            warmup_steps=args.warmup_steps, weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm, moment_dtype=args.moment_dtype,
            seed=args.seed)
        if args.gradient_accumulation_steps > 1:
            # the schedule spans `total` mini-steps but advances once per
            # emit, as in the JAX trainer (ROADMAP queue C)
            self.tx = MultiSteps(self.tx, args.gradient_accumulation_steps)
        leaves = param_leaves(params)
        self.opt_state = self.tx.init([t for _, t in leaves],
                                      [n for n, _ in leaves],
                                      blocks=fsdp.shard_blocks(params))
        if args.offload_opt_state:
            from spacer_tpu_torch.parallel.offload import offload_to_host

            self.opt_state = offload_to_host(self.opt_state)
        self.sampler = Sampler(
            cfg, eos_token_id=processor.eos_token_id,
            pad_token_id=processor.pad_token_id,
            length_bucket=args.prompt_bucket, decode_quant=args.decode_quant,
            speculate_k=args.speculate_k, mesh=mesh)
        if args.decode_quant and multihost.process_index() == 0:
            # the JAX trainer's one-line notice: the rollout SAMPLING
            # distribution is quantized; logps and updates are not
            print(f"[spacer] rollout decode quantized: "
                  f"decode_quant={args.decode_quant!r} "
                  f"(sampling-distribution change; set decode_quant=None "
                  f"for bf16-exact rollouts)", flush=True)
        self.step_fn = make_grpo_train_step(
            cfg, self.tx, beta=args.beta, remat=args.remat,
            logp_chunk=args.logp_chunk, mesh=mesh)
        self.global_step = 0
        self._metrics = defaultdict(list)
        self.logger = rank_logger(args.output_dir)

    @property
    def device(self):
        return self.params["model"]["embed_tokens"]["embedding"].device

    # -- data prep ------------------------------------------------------

    def _prepare_inputs(self, row: dict, shuffle_frames: bool = False,
                        rng: np.random.Generator | None = None, perm=None):
        """Row -> (processor outputs, has_video).  Injects the media (a path
        or a (T, H, W, C) uint8 frame array) into the first content
        element.  `shuffle_frames` permutes the video's frames by `perm`,
        or by a permutation drawn from `rng`."""
        from spacer_tpu_torch.vision.process import process_vision_info

        prompt = copy.deepcopy(row["prompt"])
        for msg in prompt:
            if isinstance(msg.get("content"), list):
                for ele in msg["content"]:
                    for k in [k for k, v in ele.items() if v is None]:
                        del ele[k]
        if row["data_type"] == "image":
            prompt[0]["content"][0]["image"] = row["path"]
        elif row["data_type"] == "video":
            prompt[0]["content"][0]["video"] = row["path"]
        if self.family.name == "aria":
            # Aria is image-only (the reference's Aria branch); its
            # processor fetches the image and sets the crop geometry itself
            return self.processor.process_messages([prompt]), False
        for msg in prompt:
            if isinstance(msg.get("content"), list):
                for ele in msg["content"]:
                    if "video" in ele or "image" in ele:
                        ele.setdefault("min_pixels", self.args.min_pixels)
                        ele.setdefault("max_pixels", self.args.max_pixels)
        images, videos, vkw = process_vision_info(
            [prompt], return_video_kwargs=True,
            device=getattr(self.processor, "device", "cpu"))
        if shuffle_frames and videos:
            if perm is None:
                perm = rng.permutation(videos[0].shape[0])
            if len(perm) != videos[0].shape[0]:
                raise ValueError(f"a permutation of {len(perm)} frames for "
                                 f"a video of {videos[0].shape[0]}")
            videos = [videos[0][perm]]
        text = self.processor.apply_chat_template(prompt,
                                                  add_generation_prompt=True)
        out = self.processor([text], images=images, videos=videos,
                             fps=vkw.get("fps"))
        return out, videos is not None and len(videos) > 0

    def _truncate_prompt(self, enc: dict):
        mp = self.args.max_prompt_length
        enc["input_ids"] = enc["input_ids"][:, -mp:]
        enc["attention_mask"] = enc["attention_mask"][:, -mp:]
        return enc

    def _collate(self, encs: list[dict]) -> dict:
        """B single-row processor outputs -> one batch dict: prompts
        left-padded to the common length, media patches/grids (Aria: image
        crops with their position ids and patch masks) concatenated in row
        order."""
        from spacer_tpu_torch.data.processor import pack_vision_inputs

        pad_id = self.processor.pad_token_id
        L = max(e["input_ids"].shape[1] for e in encs)
        ids, mask = [], []
        for e in encs:
            p = L - e["input_ids"].shape[1]
            ids.append(np.pad(e["input_ids"], ((0, 0), (p, 0)),
                              constant_values=pad_id))
            mask.append(np.pad(e["attention_mask"], ((0, 0), (p, 0))))
        out = {"input_ids": np.concatenate(ids),
               "attention_mask": np.concatenate(mask)}
        if self.family.name == "aria":
            # image crops, their NaViT ids and patch masks in row order
            with_px = [e for e in encs if "pixel_values" in e]
            if with_px:
                out.update({key: np.concatenate([e[key] for e in with_px])
                            for key in self.family.vision_batch_keys})
            return out
        pixels, vgrids, igrids, spgt, allg = [], [], [], [], []
        for e in encs:
            px, grids = pack_vision_inputs(e)
            if px is not None:
                pixels.append(px)
                allg.extend(grids)
            if "video_grid_thw" in e:
                vgrids.append(np.asarray(e["video_grid_thw"]))
                ts = e.get("second_per_grid_ts")
                spgt.extend(list(ts) if ts is not None
                            else [1.0] * len(e["video_grid_thw"]))
            if "image_grid_thw" in e:
                igrids.append(np.asarray(e["image_grid_thw"]))
        if pixels:
            out["pixel_values"] = np.concatenate(pixels).astype(np.float32)
            out["grid_thw"] = tuple(tuple(int(x) for x in g) for g in allg)
            if vgrids:
                out["video_grid_thw"] = np.concatenate(vgrids)
                out["second_per_grid_ts"] = spgt
            if igrids:
                out["image_grid_thw"] = np.concatenate(igrids)
        return out

    def _positions(self, enc: dict):
        return self.family.positions(self.cfg, enc["input_ids"],
                                     enc["attention_mask"], enc)

    def _vision_kwargs(self, enc: dict):
        return {k: enc[k] for k in self.family.vision_batch_keys
                if k in enc} or None

    # -- one training step ---------------------------------------------

    def _n_frames(self, enc: dict) -> int:
        """Frames of a prepared row's (first) video: its temporal grid
        times the temporal patch (every sampled frame count is a multiple
        of it)."""
        return (int(np.asarray(enc["video_grid_thw"])[0][0])
                * self.cfg.vision.temporal_patch_size)

    def _exchange(self, local):
        """Every rank's `local` list, concatenated in rank order (and the
        offset of this rank's part); without a mesh, `local` itself."""
        if self.mesh is None:
            return list(local), 0
        parts = multihost.all_gather_objects(list(local))
        off = sum(len(p) for p in parts[:multihost.process_index()])
        return [x for p in parts for x in p], off

    def training_step(self, rows, rng: np.random.Generator, prepared=None):
        """One optimizer step over B = len(rows) prompt-groups (with a mesh:
        this rank's rows of the global step)."""
        args = self.args
        G = args.num_generations
        if isinstance(rows, dict):
            rows = [rows]
        if prepared is not None and not isinstance(prepared, list):
            prepared = [prepared]
        B_local = len(rows)
        t_start = time.perf_counter()

        preps = prepared if prepared is not None else [
            self._prepare_inputs(r) for r in rows]
        # every rank holds the global batch's encodings; each decoded the
        # media of its own rows only
        gathered, row_off = self._exchange(
            [(self._truncate_prompt(p[0]), p[1]) for p in preps])
        encs = [e for e, _ in gathered]
        has_video = [h for _, h in gathered]
        B = len(encs)
        mine = range(row_off, row_off + B_local)
        video_idx = [b for b in range(B) if has_video[b]]
        # temporal-shuffle prompts, prepared before the rollout so both
        # decode in one grouped program; the permutations are drawn for
        # every video row in row order on every rank (one process's draws)
        s_encs = []
        if args.temporal and video_idx:
            perms = {b: rng.permutation(self._n_frames(encs[b]))
                     for b in video_idx}
            s_encs, _ = self._exchange([
                self._truncate_prompt(self._prepare_inputs(
                    rows[b - row_off], shuffle_frames=True, perm=perms[b])[0])
                for b in video_idx if b in mine])

        def rollout_seed() -> int:
            s = int(rng.integers(2**31))
            if self.mesh is not None:
                return int(multihost.broadcast_from_host0(s))
            return s

        enc = self._collate(encs)
        pos, deltas = self._positions(enc)
        grid_thw = enc.get("grid_thw")
        vision_kwargs = self._vision_kwargs(enc)
        do_temporal = args.temporal and bool(video_idx)
        merge_shuffled = do_temporal and args.merge_temporal_rollout
        gen_kw = dict(num_generations=G,
                      max_new_tokens=args.max_completion_length,
                      temperature=args.temperature, top_p=args.top_p)

        s_out = None
        if merge_shuffled:
            all_col = self._collate(encs + s_encs)
            a_pos, a_deltas = self._positions(all_col)
            out_all = self.sampler.generate(
                all_col["input_ids"], all_col["attention_mask"], self.params,
                position_ids=a_pos, deltas=a_deltas,
                vision_kwargs=self._vision_kwargs(all_col),
                grid_thw=all_col.get("grid_thw"),
                seed=rollout_seed(), **gen_kw)
            n_main = B * G
            sample_out = SampleOutput(
                sequences=out_all.sequences[:n_main],
                completion_mask=out_all.completion_mask[:n_main],
                lengths=out_all.lengths[:n_main], stats=out_all.stats)
            s_out = SampleOutput(
                sequences=out_all.sequences[n_main:],
                completion_mask=out_all.completion_mask[n_main:],
                lengths=out_all.lengths[n_main:])
        else:
            sample_out = self.sampler.generate(
                enc["input_ids"], enc["attention_mask"], self.params,
                position_ids=pos, deltas=deltas, vision_kwargs=vision_kwargs,
                grid_thw=grid_thw, seed=rollout_seed(), **gen_kw)
        # decode only the rows this rank scores
        lsl = slice(row_off * G, (row_off + B_local) * G)
        completions = self.processor.tokenizer.batch_decode(
            [seq[:n] for seq, n in zip(sample_out.sequences[lsl],
                                       sample_out.lengths[lsl])],
            skip_special_tokens=True)
        t_rollout = time.perf_counter()

        # the (advantage-free) shared-prefix train batch
        P_len = enc["input_ids"].shape[1]
        Pb = self.sampler._bucket(P_len)
        pad = Pb - P_len
        prompt_ids_p = np.pad(enc["input_ids"], ((0, 0), (pad, 0)),
                              constant_values=self.processor.pad_token_id)
        prompt_mask_p = np.pad(enc["attention_mask"], ((0, 0), (pad, 0)))
        pos_p = np.pad(pos, ((0, 0), (0, 0), (pad, 0)), constant_values=1)
        C = args.max_completion_length
        comp_pos = (np.asarray(deltas).reshape(-1, 1) - pad) + Pb \
            + np.arange(C)[None, :]
        comp_pos = np.repeat(comp_pos, G, axis=0)  # (B*G, C)
        dev = self.device

        def tensor(a, dtype=torch.long):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        batch = {
            "prompt_ids": tensor(prompt_ids_p),
            "prompt_mask": tensor(prompt_mask_p),
            "prompt_position_ids": tensor(pos_p),
            "completion_ids": tensor(sample_out.sequences),
            "completion_position_ids": tensor(
                np.broadcast_to(comp_pos[None], (3, B * G, C))),
            "completion_mask": tensor(sample_out.completion_mask),
        }
        if vision_kwargs is not None:
            batch.update(vision_kwargs)
        ref_logps = self.step_fn.ref_logps_fn(
            self.ref_params, batch, grid_thw, G)

        # temporal-shuffle rewards (G/2 generations per video row) of this
        # rank's rows
        shuffled_rewards = {}
        if do_temporal:
            Gs = G // 2
            if merge_shuffled:
                keep = np.concatenate([np.arange(j * G, j * G + Gs)
                                       for j in range(len(video_idx))])
                s_seqs, s_lens = s_out.sequences[keep], s_out.lengths[keep]
            else:
                s_col = self._collate(s_encs)
                s_pos, s_deltas = self._positions(s_col)
                s_sep = self.sampler.generate(
                    s_col["input_ids"], s_col["attention_mask"], self.params,
                    position_ids=s_pos, deltas=s_deltas,
                    vision_kwargs=self._vision_kwargs(s_col),
                    grid_thw=s_col.get("grid_thw"),
                    seed=rollout_seed(),
                    **dict(gen_kw, num_generations=Gs))
                s_seqs, s_lens = s_sep.sequences, s_sep.lengths
            for j, b in enumerate(video_idx):
                if b not in mine:
                    continue
                s_comp = self.processor.tokenizer.batch_decode(
                    [seq[:n] for seq, n in zip(s_seqs[j * Gs:(j + 1) * Gs],
                                               s_lens[j * Gs:(j + 1) * Gs])],
                    skip_special_tokens=True)
                shuffled_rewards[b] = self._compute_rewards(
                    rows[b - row_off], s_comp)

        local_rewards = [
            self._compute_rewards(rows[j], completions[j * G:(j + 1) * G])
            for j in range(B_local)]
        # one exchange carries the main and the shuffled local rewards
        parts, _ = self._exchange([(local_rewards, shuffled_rewards)])
        rewards_per_func = np.concatenate([r for p in parts for r in p[0]])
        shuffled_rewards = {}
        for p in parts:
            shuffled_rewards.update(p[1])
        temporal_flags = []
        rewards = np.zeros(B * G, np.float32)
        for b in range(B):
            sl = slice(b * G, (b + 1) * G)
            rpf = rewards_per_func[sl]
            if args.temporal and b in shuffled_rewards:
                rpf, flag = temporal_bonus(rpf, shuffled_rewards[b])
                rewards_per_func[sl] = rpf
                temporal_flags.append(flag)
            r = rpf.sum(axis=1)
            if args.len_control:
                r = length_control_bonus(r, rpf[:, 0], sample_out.lengths[sl])
            rewards[sl] = r
        advantages = group_advantages(torch.from_numpy(rewards), G)
        t_reward = time.perf_counter()

        batch["advantages"] = advantages.to(device=dev, dtype=torch.float32)
        if ref_logps is not None:
            batch["ref_logps"] = ref_logps
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.ref_params, self.opt_state, batch,
            grid_thw=grid_thw, num_generations=G)
        t_update = time.perf_counter()

        m = self._metrics
        m["completion_length"].append(float(sample_out.lengths.mean()))
        for i, fn in enumerate(self.reward_funcs):
            m[f"rewards/{getattr(fn, '__name__', f'reward_{i}')}"].append(
                float(rewards_per_func[:, i].mean()))
        group = rewards.reshape(-1, G)
        m["all_wrong"].append(float((group <= 1).all(axis=1).mean()))
        m["all_correct"].append(float((group >= 2).all(axis=1).mean()))
        if args.temporal:
            m["temporal_rewards"].append(
                float(np.mean(temporal_flags)) if temporal_flags else 0.5)
        m["reward"].append(float(rewards.mean()))
        m["reward_std"].append(float(group.std(axis=1, ddof=1).mean()))
        if sample_out.stats and "spec_acceptance" in sample_out.stats:
            m["spec_acceptance"].append(sample_out.stats["spec_acceptance"])
        m["kl"].append(float(metrics["kl"]))
        m["loss"].append(float(metrics["loss"]))
        m["grad_norm"].append(float(metrics["grad_norm"]))
        m["time/rollout_s"].append(t_rollout - t_start)
        m["time/reward_s"].append(t_reward - t_rollout)
        m["time/update_s"].append(t_update - t_reward)
        return metrics

    def _compute_rewards(self, row: dict, completions: list[str]) -> np.ndarray:
        n = len(completions)
        out = np.zeros((n, len(self.reward_funcs)), np.float32)
        reward_kwargs = {k: [row[k]] * n for k in row.keys()
                         if k not in ("prompt", "completion")}
        comps = [[{"content": c}] for c in completions]
        for i, fn in enumerate(self.reward_funcs):
            kwargs = dict(reward_kwargs)
            if getattr(fn, "needs_map_data", False):
                kwargs["map_data"] = self.map_data
            vals = fn(completions=comps,
                      solution=reward_kwargs.get("solution", [""] * n),
                      **{k: v for k, v in kwargs.items() if k != "solution"})
            out[:, i] = np.asarray(vals, np.float32)
        return out

    # -- loop ------------------------------------------------------------

    def train(self, resume_from_checkpoint: str | None = None):
        args = self.args
        if resume_from_checkpoint:
            self.load_checkpoint(resume_from_checkpoint)
        # epoch order is a pure function of the seed, so resume recovers the
        # dataloader position from global_step alone
        rng = np.random.default_rng(args.seed)
        B = max(1, args.rollout_batch_size)
        steps_per_epoch = -(-len(self.dataset) // B)
        total = args.max_steps or (steps_per_epoch * args.num_train_epochs)
        start_epoch = self.global_step // steps_per_epoch
        for epoch in range(args.num_train_epochs):
            order = np.random.default_rng(args.seed + epoch).permutation(
                len(self.dataset))
            if epoch < start_epoch:
                continue
            # each rank takes its contiguous share of every global chunk
            chunks = [self._rank_share(order[i:i + B])
                      for i in range(0, len(order), B)]
            skip = (self.global_step % steps_per_epoch
                    if epoch == start_epoch else 0)
            for ci in range(skip, len(chunks)):
                if self.global_step >= total:
                    return
                chunk_rows = [self.dataset[int(j)] for j in chunks[ci]]
                try:
                    self.training_step(chunk_rows, rng)
                except Exception as e:
                    self.logger.log_event(
                        {"step": self.global_step, "error": repr(e),
                         "problem_id": [r.get("problem_id")
                                        for r in chunk_rows]})
                    if not args.skip_failed_steps or self.mesh is not None:
                        raise
                    continue
                self.global_step += 1
                if self.global_step % args.logging_steps == 0:
                    self._flush_metrics()
                if self.global_step % args.save_steps == 0:
                    self.save_checkpoint()

    def _rank_share(self, chunk):
        """This rank's contiguous share of a global chunk of rows."""
        if self.mesh is None:
            return chunk
        n, r = multihost.process_count(), multihost.process_index()
        return chunk[r * len(chunk) // n:(r + 1) * len(chunk) // n]

    def _flush_metrics(self):
        avg = {k: sum(v) / len(v) for k, v in self._metrics.items() if v}
        if self.mesh is not None:
            # the rank-local timings averaged over the ranks (the others
            # are the same on every rank already)
            avg = {k: (multihost.mean_across_hosts(v)
                       if k.startswith("time/") else v)
                   for k, v in avg.items()}
        avg["step"] = self.global_step
        self.logger.log_metrics(avg)
        self._metrics.clear()

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, path: str | None = None):
        from spacer_tpu_torch.train.checkpoint import (
            save_model_only,
            save_train_state,
        )

        path = path or os.path.join(self.args.output_dir,
                                    f"checkpoint-{self.global_step}")
        if self.args.save_only_model:
            return save_model_only(path, self.params)
        save_train_state(path, self.params, self.opt_state,
                         {"global_step": self.global_step})
        return path

    def save_pretrained(self, out_dir: str | None = None,
                        processor_dir: str | None = None):
        """HF-layout export (model.safetensors + config.json + processor
        files) and, with `push_to_hub`, the upload (SG-RLVR.py:383-386)."""
        from spacer_tpu_torch.train import publish

        out_dir = out_dir or os.path.join(self.args.output_dir, "final")
        if self.args.push_to_hub and not self.args.hub_model_id:
            # fail before the export: a basename fallback would publish to
            # a repo literally named "final"
            raise ValueError(
                "push_to_hub=True requires hub_model_id (the Hub repo id); "
                "refusing to invent one from the output directory name")
        # the full params (tp slices joined), written by rank 0
        params = fsdp.full_params(self.params)
        if multihost.process_index() == 0:
            publish.save_pretrained(out_dir, params, self.cfg,
                                    processor_dir=processor_dir)
            if self.args.push_to_hub:
                publish.push_to_hub(self.args.hub_model_id, out_dir)
        del params
        multihost.barrier()
        return out_dir

    def load_checkpoint(self, path: str):
        from spacer_tpu_torch.train.checkpoint import restore_train_state

        self.params, opt_state, meta = restore_train_state(
            path, self.params, self.opt_state)
        if self.args.offload_opt_state:
            from spacer_tpu_torch.parallel.offload import restore_into

            # into the host arena allocated at construction
            opt_state = restore_into(self.opt_state, opt_state)
        self.opt_state = opt_state
        self.global_step = int(meta.get("global_step", 0))


def _clone(t):
    if isinstance(t, fsdp.Shard):
        return fsdp.Shard(t.data.detach().clone(), t.shape, t.mesh, t.split,
                          t.experts)
    return t.detach().clone()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
