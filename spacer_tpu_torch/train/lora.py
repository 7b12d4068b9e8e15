"""LoRA adapters over the params tree (counterpart of
spacer_tpu/train/lora.py).

Behavioral reference: the PEFT path of the reference trainer
(SG_RLVR_trainer.py:200-221, 539-540): adapters train while the base stays
frozen, and the reference policy is the model with the adapters DISABLED,
so no reference copy of the params is held (`disable_adapter()`).

Adapters target dense kernels by regex over the port's param paths, the
`param_leaves` names, which carry the layer index
("model/layers/3/self_attn/q_proj/kernel"); the JAX package matches its
stacked paths, which do not ("model/layers/self_attn/q_proj/kernel").
`stacked_path` maps a port path to the JAX one, and the default pattern
selects the same tensors.  Each target gets a: (in, r), drawn from an
explicit torch.Generator, and b: (r, out), zero, so step 0 is the base
model.  `merge_lora` forms base + scale * a @ b for the forward pass.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from spacer_tpu_torch.train.optimizer import _stacked_key


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: int = 16
    target_patterns: tuple = (
        r"model/layers/\d+/self_attn/(q|k|v|o)_proj/kernel",
    )

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def stacked_path(name: str) -> str:
    """A port param path as the JAX package's stacked tree names it (the
    per-layer index dropped): 'model/layers/3/mlp/up_proj/kernel' ->
    'model/layers/mlp/up_proj/kernel'."""
    key = _stacked_key(name)
    return name if key is None else key.replace("/*", "", 1)


def _is_target(name: str, cfg: LoraConfig) -> bool:
    return any(re.search(p, name) for p in cfg.target_patterns)


def init_lora_params(generator: torch.Generator, params, cfg: LoraConfig,
                     dtype=None) -> dict:
    """{param path: {"a": (in, r), "b": (r, out)}} for every targeted kernel
    of at least 2 dims, in param_leaves order; a ~ N(0, 1/in) from
    `generator` (which must live on the params' device), b = 0."""
    from spacer_tpu_torch.train.step import param_leaves

    lora = {}
    for name, leaf in param_leaves(params):
        if leaf.dim() < 2 or not _is_target(name, cfg):
            continue
        d_in, d_out = leaf.shape[-2:]
        dt = dtype or leaf.dtype
        a = torch.randn((*leaf.shape[:-1], cfg.r), generator=generator,
                        device=leaf.device) * d_in ** -0.5
        lora[name] = {"a": a.to(dt),
                      "b": torch.zeros((*leaf.shape[:-2], cfg.r, d_out),
                                       dtype=dt, device=leaf.device)}
    return lora


def lora_leaves(lora: dict):
    """[(path, tensor)] of the adapters in a fixed order (a, then b, per
    target): the optimizer's flat list."""
    return [(f"{name}/{k}", ab[k]) for name, ab in lora.items()
            for k in ("a", "b")]


def merge_lora(params, lora: dict, cfg: LoraConfig):
    """The params with base + scale * a @ b at every targeted kernel; the
    other tensors are the params' own (not copied)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        ab = lora.get(prefix[:-1])
        if ab is None:
            return tree
        delta = torch.matmul(ab["a"], ab["b"]) * cfg.scale
        return tree + delta.to(tree.dtype)

    return walk(params, "")


def make_lora_grpo_train_step(model_cfg, tx, lora_cfg: LoraConfig, *,
                              beta: float = 0.04, remat=True, attn_impl=None,
                              logp_chunk: int = 256):
    """GRPO step that trains only the adapters:
    step(base_params, lora, opt_state, batch, grid_thw, num_generations)
    -> (lora, opt_state, metrics).  The reference logps come from the base
    (adapters disabled), so no reference copy is kept; the base is frozen
    (its requires_grad is cleared) and bitwise unchanged.  `tx` was
    initialised over `lora_leaves(lora)`.

    The batch takes make_grpo_train_step's two schemas, dispatched on
    "prompt_ids" as there: the trainer's shared-prefix one, or the packed
    one (input_ids / kv_mask) the JAX step takes, whose logps and gradients
    are the same (tests/test_torch_train_step.py holds the two forms
    equal).  `attn_impl` None or ("ring", mesh, axis) reaches the ViT and
    the logps as in make_grpo_train_step (the ring runs the whole batch on
    every rank of its mesh)."""
    from spacer_tpu_torch.models.qwen25_vl.language import check_remat
    from spacer_tpu_torch.models.registry import family_for_config
    from spacer_tpu_torch.train.grpo import grpo_loss
    from spacer_tpu_torch.train.optimizer import global_norm
    from spacer_tpu_torch.train.step import (
        _check_parallel,
        _completion_logps_shared,
        _packed_logps,
        param_leaves,
    )

    remat = check_remat(remat)
    family = family_for_config(model_cfg)
    _check_parallel(None, attn_impl, None)

    def logps_with(params, batch, grid_thw, num_generations):
        vk = {k: batch[k] for k in family.vision_batch_keys if k in batch}
        ve = (family.encode_vision(params, model_cfg, vk, grid_thw,
                                   remat=remat, attn_impl=attn_impl)
              if vk else None)
        if "prompt_ids" not in batch:
            return _packed_logps(params, model_cfg, batch, ve, grid_thw,
                                num_generations, remat=remat,
                                logp_chunk=logp_chunk, attn_impl=attn_impl)
        return _completion_logps_shared(
            params, model_cfg, batch["prompt_ids"],
            batch["prompt_position_ids"], batch["prompt_mask"],
            batch["completion_ids"], batch["completion_position_ids"],
            batch["completion_mask"], num_generations, vision_embeds=ve,
            remat=remat, logp_chunk=logp_chunk,
            merge_fn=family.merge_vision_embeds, attn_impl=attn_impl)

    def loss_and_grads(base_params, lora, batch, grid_thw=None,
                       num_generations: int = 1):
        """-> (loss, metrics, grads in lora_leaves order)."""
        for _, t in param_leaves(base_params):
            t.requires_grad_(False)
        ref_logps = None
        if beta != 0.0:
            with torch.no_grad():
                ref_logps = logps_with(base_params, batch, grid_thw,
                                       num_generations)
        leaves = [t for _, t in lora_leaves(lora)]
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            merged = merge_lora(base_params, lora, lora_cfg)
            logps = logps_with(merged, batch, grid_thw, num_generations)
            loss, metrics = grpo_loss(logps, ref_logps, batch["advantages"],
                                      batch["completion_mask"], beta=beta)
            grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), metrics, grads

    def step(base_params, lora, opt_state, batch, grid_thw=None,
             num_generations: int = 1):
        loss, metrics, grads = loss_and_grads(base_params, lora, batch,
                                              grid_thw, num_generations)
        gnorm = global_norm(grads)
        opt_state = tx.apply(grads, opt_state,
                             [t for _, t in lora_leaves(lora)], gnorm=gnorm)
        del grads
        return lora, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    step.loss_and_grads = loss_and_grads
    return step
