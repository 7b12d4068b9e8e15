"""Checkpointing with torch.save / torch.load (counterpart of
spacer_tpu/train/checkpoint.py, which uses Orbax).

A train-state checkpoint is a directory holding `params.pt` (the nested
params tree), `opt_state.pt` (the optimizer state: moments, count and, with
gradient accumulation, the accumulator and its mini-step) and `meta.json`.
Restoring maps the params onto the device of `params_like` and the state
onto that of `opt_state_like` (host memory for an offloaded state), so a
checkpoint saved on one device loads onto another.
"""

from __future__ import annotations

import json
import os

import torch


def _like_device(like):
    """The device of the first tensor in a nested tree (None if none)."""
    if isinstance(like, torch.Tensor):
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
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, "params.pt"))
    torch.save(opt_state, os.path.join(path, "opt_state.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(metadata, f)
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
    return params, opt_state, meta


def save_model_only(path: str, params):
    """--save_only_model equivalent."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, "params.pt"))
    return path

