"""The MoE feed-forward: spacer_tpu_torch.ops.moe against spacer_tpu.ops.moe
on the same numpy weights and inputs, float32 on the CPU.

Router weights are drawn wide (normal 0.5, as tests/test_aria_generate.py
does) so that no near-tie of two router logits can flip the top-k choice
between the two packages.  Tolerance 1e-4 abs/rel: the routed product, the
f32 weighted sum and the shared SwiGLU differ in summation order only
(~1e-6 per op).  The grouped product's custom backward is held against
autograd through its per-group loop (grouped_mm_reference) at 1e-5: both
run the same f32 products, per group, in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.ops.moe import init_moe_params as jax_init_moe_params
from spacer_tpu.ops.moe import moe_mlp as jax_moe_mlp
from spacer_tpu.ops.moe import route_topk as jax_route_topk
from spacer_tpu_torch.models.qwen25_vl.convert import _convert
from spacer_tpu_torch.ops import moe

TOL = dict(atol=1e-4, rtol=1e-4)
D, I, E, K, SHARED = 64, 32, 8, 2, 2


@pytest.fixture(scope="module")
def layer():
    params = jax.tree.map(np.asarray, jax_init_moe_params(
        jax.random.key(3), D, I, E, SHARED, jnp.float32))
    params["router"]["kernel"] = np.random.default_rng(0).normal(
        0, 0.5, (D, E)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(3, 5, D)).astype(np.float32)
    return params, _convert(params, None, "cpu"), x


def test_route_topk_matches_jax(layer):
    params, tparams, x = layer
    xt = x.reshape(-1, D)
    js, ji = jax_route_topk(jnp.asarray(params["router"]["kernel"]),
                            jnp.asarray(xt), K)
    scores, idx = moe.route_topk(tparams["router"]["kernel"],
                                 torch.from_numpy(xt), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(scores.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_moe_mlp_matches_jax(layer, impl):
    params, tparams, x = layer
    ref = jax_moe_mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                      topk=K, impl=impl)
    got = moe.moe_mlp(tparams, torch.from_numpy(x), topk=K, impl=impl)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_grouped_mm_backward_matches_autograd_loop():
    rng = np.random.default_rng(2)
    sizes = torch.tensor([3, 0, 5, 1, 7])           # an empty group too
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8, 12)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32))
    grads = []
    for fn in (moe.grouped_mm, moe.grouped_mm_reference):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fn(xg, wg, sizes)
        grads.append((out.detach(), *torch.autograd.grad(out, (xg, wg), dy)))
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_moe_mlp_gradients_match_dense_oracle(layer):
    """The ragged path's gradients (through the grouped products' custom
    backward) equal the dense oracle's (plain einsums)."""
    params, _, x = layer
    grads = []
    for impl in ("ragged", "dense"):
        p = _convert(params, None, "cpu")
        leaves = [p["experts"]["fc1"]["kernel"], p["experts"]["fc2"]["kernel"]]
        xt = torch.from_numpy(x).requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
        out = moe.moe_mlp(p, xt, topk=K, impl=impl)
        grads.append(torch.autograd.grad(out.square().sum(), [xt, *leaves]))
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_moe_ep_impl_raises(layer):
    """impl "ep" runs (moe_mlp_ep: tests/test_torch_moe_ep.py holds it to
    JAX's) and equals the dropless path where nothing drops; over "data"
    and ("data", "fsdp") it is the fsdp output bit for bit (one process:
    the axis moves data, not values, as in JAX); another ep axis and an
    unknown impl raise ValueError."""
    _, tparams, x = layer
    xt = torch.from_numpy(x)
    got = moe.moe_mlp(tparams, xt, topk=K, impl="ep", capacity_factor=8.0)
    np.testing.assert_allclose(
        got.numpy(), moe.moe_mlp(tparams, xt, topk=K).numpy(), **TOL)
    for axis in ("data", ("data",), ("data", "fsdp"), ["data", "fsdp"]):
        assert torch.equal(moe.moe_mlp(tparams, xt, topk=K, impl="ep",
                                       capacity_factor=8.0, ep_axis=axis),
                           got)
    for axis in ("tp", ("fsdp", "data"), "pipe"):
        with pytest.raises(ValueError, match="expert parallelism runs over"):
            moe.moe_mlp(tparams, xt, topk=K, impl="ep", ep_axis=axis)
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_mlp(tparams, torch.from_numpy(x), topk=K, impl="sparse")
