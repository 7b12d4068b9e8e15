"""Checkpointing with torch.save / torch.load (counterpart of
spacer_tpu/train/checkpoint.py, which uses Orbax).

A train-state checkpoint is a directory holding `params.pt` (the nested
params tree), `opt_state.pt` (the optimizer state: moments, count and, with
gradient accumulation, the accumulator and its mini-step) and `meta.json`.
Restoring maps the params onto the device of `params_like` and the state
onto that of `opt_state_like` (host memory for an offloaded state), so a
checkpoint saved on one device loads onto another.

Sharded params (parallel/fsdp.py; fsdp blocks of tp slices too) save as
the full tensors and the world-1 optimizer state, gathered on every rank and written by rank 0, so
a checkpoint is the same whatever the world that wrote it; restoring cuts
it for the current world (the Shards of `params_like`), whatever the
world was at save: JAX's cross-topology resume (`_restore_tree`).  A
model-only checkpoint (`save_model_only`, `params.pt` alone) reads back
with `load_model_only`.
"""

from __future__ import annotations

import json
import os

import torch

from spacer_tpu_torch.parallel import fsdp, multihost


def _like_device(like):
    """The device of the first tensor in a nested tree (None if none)."""
    if isinstance(like, (torch.Tensor, fsdp.Shard)):
        return like.device
    items = (like.values() if isinstance(like, dict)
             else like if isinstance(like, (list, tuple)) else ())
    for v in items:
        dev = _like_device(v)
        if dev is not None:
            return dev
    return None


def save_train_state(path: str, params, opt_state, metadata: dict):
    path = os.path.abspath(path)
    if fsdp.has_shards(params):
        opt_state = fsdp.state_to_full(opt_state, params)
        params = fsdp.full_params(params)
    if multihost.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(params, os.path.join(path, "params.pt"))
        torch.save(opt_state, os.path.join(path, "opt_state.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(metadata, f)
    multihost.barrier()
    return path


def restore_train_state(path: str, params_like, opt_state_like):
    path = os.path.abspath(path)
    params = torch.load(os.path.join(path, "params.pt"),
                        map_location=_like_device(params_like),
                        weights_only=False)
    opt_state = torch.load(os.path.join(path, "opt_state.pt"),
                           map_location=(_like_device(opt_state_like)
                                         or _like_device(params_like)),
                           weights_only=False)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if fsdp.has_shards(params_like):
        params = fsdp.params_from_full(params, params_like)
        opt_state = fsdp.state_from_full(opt_state, params_like)
    return params, opt_state, meta


def save_model_only(path: str, params):
    """--save_only_model equivalent."""
    path = os.path.abspath(path)
    params = fsdp.full_params(params)
    if multihost.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(params, os.path.join(path, "params.pt"))
    multihost.barrier()
    return path


def load_model_only(path: str, params_like=None):
    """The params `save_model_only` wrote: the full tree on the CPU, or with
    `params_like` on its device and cut for its fsdp / tp Shards (any
    world, as restore_train_state)."""
    path = os.path.abspath(path)
    params = torch.load(os.path.join(path, "params.pt"),
                        map_location=(_like_device(params_like)
                                      if params_like is not None else "cpu"),
                        weights_only=False)
    if params_like is not None and fsdp.has_shards(params_like):
        params = fsdp.params_from_full(params, params_like)
    return params
