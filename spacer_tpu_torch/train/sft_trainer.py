"""SFT trainer (counterpart of spacer_tpu/train/sft_trainer.py; sft.py
parity): chat-template collation with pad / visual label masking,
next-token cross-entropy through `make_sft_train_step`, on one device or,
with a device mesh (parallel/mesh.py), on each of its ranks: as in the
JAX trainer, every rank collates the same batch of `per_device_batch_size`
rows (the global batch), and the step runs each rank's rows of it over
the fsdp-sharded params.  Only rank 0 writes metrics and checkpoints.

Behavioral reference: sft.py:84-182 (prepare_dataset, collate_fn masking ids
{pad, 151652, 151653, 151656}) and :184-272 (loop / save).  The prompt
templates are copied from the JAX module.
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index
from spacer_tpu_torch.parallel import fsdp
from spacer_tpu_torch.train.optimizer import make_optimizer
from spacer_tpu_torch.train.step import make_sft_train_step, param_leaves
from spacer_tpu_torch.utils.logging import rank_logger

SFT_SYSTEM_MESSAGE = "You are a helpful assistant"

SFT_QUESTION_TEMPLATE = (
    "{Question}\n"
    "Please think about this question as if you were a human pondering deeply. "
    "Engage in an internal dialogue using expressions such as 'let me think', "
    "'wait', 'Hmm', 'oh, I see', 'let's break it down', etc, or other natural "
    "language thought expressions "
    "It's encouraged to include self-reflection or verification in the "
    "reasoning process. "
    "Provide your detailed reasoning between the <think> </think> tags, and "
    "then give your final answer between the <answer> </answer> tags."
)

SFT_TYPE_TEMPLATE = {
    "multiple choice": (
        " Please provide only the single option letter (e.g., A, B, C, D, "
        "etc.) within the <answer> </answer> tags."
    ),
    "numerical": (
        " Please provide the numerical value (e.g., 42 or 3.14) within the "
        "<answer> </answer> tags."
    ),
    "OCR": (
        " Please transcribe text from the image/video clearly and provide "
        "your text answer within the <answer> </answer> tags."
    ),
    "free-form": (
        " Please provide your text answer within the <answer> </answer> tags."
    ),
    "regression": (
        " Please provide the numerical value (e.g., 42 or 3.14) within the "
        "<answer> </answer> tags."
    ),
}


def prepare_sft_example(example: dict) -> dict:
    """Row -> {'messages': [...]} (sft.py:84-145 parity)."""
    if example["problem_type"] == "multiple choice":
        question = example["problem"] + "Options:\n"
        for op in example["options"]:
            question += op + "\n"
    else:
        question = example["problem"]
    messages = [
        {"role": "system",
         "content": [{"type": "text", "text": SFT_SYSTEM_MESSAGE}]},
        {"role": "user", "content": [
            {"type": example["data_type"],
             example["data_type"]: example["path"]},
            {"type": "text",
             "text": SFT_QUESTION_TEMPLATE.format(Question=question)
             + SFT_TYPE_TEMPLATE[example["problem_type"]]},
        ]},
        {"role": "assistant",
         "content": [{"type": "text", "text": example["solution"]}]},
    ]
    return {"messages": messages}


@dataclasses.dataclass
class SFTConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 5.0
    num_train_epochs: int = 1
    max_steps: int | None = None
    per_device_batch_size: int = 1
    logging_steps: int = 1
    save_steps: int = 1000
    output_dir: str = "sft_output"
    seed: int = 42
    # False | True | "dots" | "dots_narrow" | "dots_mixed:K" (check_remat)
    remat: Any = True
    logp_chunk: int = 256
    # the JAX trainer's field, kept so its configs parse; only None is
    # accepted (the port has one attention path per device)
    attn_impl: Optional[str] = None
    warmup_steps: int = 0
    seq_bucket: int = 512
    # Adam moment storage (train/optimizer.py): "float32" (torch AdamW
    # parity) or "int8" (the 8-bit-Adam role, ~2 bytes/param)
    moment_dtype: str = "float32"


class SFTTrainer:
    """SFT on the params' device; with a `mesh`, one rank of it."""

    def __init__(self, cfg, params, processor, train_dataset: Sequence[dict],
                 args: SFTConfig, mesh=None):
        from spacer_tpu_torch.train.trainer import _unported

        _unported(args, mesh, cfg)
        self.cfg = cfg
        self.args = args
        self.processor = processor
        self.dataset = [r if "messages" in r else {**r, **prepare_sft_example(r)}
                        for r in train_dataset]
        self.params = params
        total = args.max_steps or args.num_train_epochs * len(self.dataset)
        self.tx = make_optimizer(
            learning_rate=args.learning_rate, total_steps=total,
            warmup_steps=args.warmup_steps, weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm, moment_dtype=args.moment_dtype,
            seed=args.seed)
        leaves = param_leaves(params)
        self.opt_state = self.tx.init([t for _, t in leaves],
                                      [n for n, _ in leaves],
                                      blocks=fsdp.shard_blocks(params))
        self.step_fn = make_sft_train_step(cfg, self.tx, remat=args.remat,
                                           logp_chunk=args.logp_chunk,
                                           mesh=mesh)
        self.global_step = 0
        self._metrics = defaultdict(list)
        self.logger = rank_logger(args.output_dir)

    @property
    def device(self):
        return self.params["model"]["embed_tokens"]["embedding"].device

    def collate(self, examples: list[dict]) -> tuple[dict, Any]:
        """Rows -> (batch of tensors on the params' device, grid_thw), with
        labels = input_ids and -100 on padding and the visual tokens
        (vision start / end and the video placeholders), left-padded to a
        multiple of `seq_bucket`."""
        enc = self.processor.process_messages(
            [e["messages"] for e in examples], add_generation_prompt=False)
        labels = enc["input_ids"].astype(np.int64).copy()
        labels[labels == self.processor.pad_token_id] = -100
        for visual in (self.cfg.vision_start_token_id,
                       self.cfg.vision_end_token_id,
                       self.cfg.video_token_id):
            labels[labels == visual] = -100
        pos, _ = get_rope_index(
            self.cfg, enc["input_ids"],
            image_grid_thw=enc.get("image_grid_thw"),
            video_grid_thw=enc.get("video_grid_thw"),
            second_per_grid_ts=enc.get("second_per_grid_ts"),
            attention_mask=enc["attention_mask"])
        S = enc["input_ids"].shape[1]
        b = self.args.seq_bucket
        pad = max(b, -(-S // b) * b) - S
        arrays = {
            "input_ids": np.pad(enc["input_ids"], ((0, 0), (pad, 0)),
                                constant_values=self.processor.pad_token_id),
            "labels": np.pad(labels, ((0, 0), (pad, 0)), constant_values=-100),
            "kv_mask": np.pad(enc["attention_mask"], ((0, 0), (pad, 0))
                              ).astype(bool),
            "position_ids": np.pad(pos, ((0, 0), (0, 0), (pad, 0)),
                                   constant_values=1),
        }
        grid_thw = None
        for px, grids in (("pixel_values_videos", "video_grid_thw"),
                          ("pixel_values", "image_grid_thw")):
            if grids in enc:
                arrays["pixel_values"] = np.asarray(enc[px], np.float32)
                grid_thw = tuple(tuple(int(x) for x in g) for g in enc[grids])
                break
        dev = self.device
        batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                 for k, v in arrays.items()}
        for k in ("input_ids", "labels", "position_ids"):
            batch[k] = batch[k].long()
        return batch, grid_thw

    def train(self):
        args = self.args
        order = np.random.default_rng(args.seed).permutation(len(self.dataset))
        total = args.max_steps or len(order) * args.num_train_epochs
        bs = args.per_device_batch_size
        for _ in range(args.num_train_epochs):
            for start in range(0, len(order), bs):
                if self.global_step >= total:
                    return
                rows = [self.dataset[int(i)] for i in order[start:start + bs]]
                batch, grid_thw = self.collate(rows)
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, grid_thw=grid_thw)
                self.global_step += 1
                self._metrics["loss"].append(float(metrics["loss"]))
                self._metrics["grad_norm"].append(float(metrics["grad_norm"]))
                if self.global_step % args.logging_steps == 0:
                    avg = {k: sum(v) / len(v) for k, v in self._metrics.items()}
                    avg["step"] = self.global_step
                    self.logger.log_metrics(avg)
                    self._metrics.clear()
                if self.global_step % args.save_steps == 0:
                    self.save_checkpoint()

    def save_checkpoint(self, path: str | None = None):
        from spacer_tpu_torch.train.checkpoint import save_train_state

        path = path or os.path.join(self.args.output_dir,
                                    f"checkpoint-{self.global_step}")
        return save_train_state(path, self.params, self.opt_state,
                                {"global_step": self.global_step})
