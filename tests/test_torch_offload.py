"""Optimizer-state offload of spacer_tpu_torch (counterpart of
tests/test_offload.py) and the in-place, one-moment-group-at-a-time
optimizer apply.

On the CPU "host" and "device" are one memory: offloaded state stays where
it is and the streaming loop hands it over as it is, as JAX's CPU backend
runs its offload, so the CPU tests hold the protocol (offload, three
updates, back) to the on-device state bitwise.  The test marked `gpu`
repeats that on the card, where the moments really stream through a side
stream from a registered host arena.  Every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
from spacer_tpu_torch.parallel import is_on_host, offload_to_host, to_device
from spacer_tpu_torch.parallel.offload import GroupStream
from spacer_tpu_torch.train.optimizer import MultiSteps, make_optimizer
from spacer_tpu_torch.train.step import param_leaves

MOMENTS = ("int8", "float32", "bfloat16")


def _leaves(device="cpu", dtype=torch.float32):
    params = init_params(tiny_config(), seed=0, dtype=dtype, device=device)
    leaves = param_leaves(params)
    return [t for _, t in leaves], [n for n, _ in leaves]


def _grads(params, step):
    gen = torch.Generator().manual_seed(step)
    return [(torch.randn(p.shape, generator=gen) * 0.1).to(p.device, p.dtype)
            for p in params]


def _flat(state):
    out = []
    for x in state:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_flat(x))
    return out


def _assert_equal(a, b):
    ta, tb = _flat(a), _flat(b)
    assert len(ta) == len(tb) and ta
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_offload_roundtrip_preserves_values_and_dtypes(moment_dtype):
    params, names = _leaves()
    tx = make_optimizer(learning_rate=1e-3, total_steps=10,
                        moment_dtype=moment_dtype)
    state = tx.init(params, names)
    state = tx.apply(_grads(params, 0), state, params)
    host = offload_to_host(state)
    assert is_on_host(host)
    back = to_device(host, "cpu")
    assert back.count == state.count == 1
    _assert_equal(state, back)
    # accumulation state: the accumulator and the inner moments together
    ms = MultiSteps(tx, 2)
    acc_state = ms.apply(_grads(params, 1), ms.init(params, names), params)
    assert is_on_host(offload_to_host(acc_state))
    _assert_equal(acc_state, to_device(offload_to_host(acc_state), "cpu"))


def _three_updates(tx, params, names, offload):
    state = tx.init(params, names)
    for step in range(3):
        if offload:
            state = offload_to_host(state)
        state = tx.apply(_grads(params, step), state, params)
        if offload:
            assert is_on_host(offload_to_host(state))
    return state


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_update_with_host_resident_state_matches_device(moment_dtype):
    """The trainer's protocol (moments offloaded between updates, streamed
    through the update) gives the on-device state's params and moments
    bitwise, over three AdamW updates with int8 stochastic rounding on."""
    kw = dict(learning_rate=1e-3, total_steps=10, moment_dtype=moment_dtype,
              max_grad_norm=0.5, seed=3)
    p_dev, names = _leaves()
    p_host, _ = _leaves()
    s_dev = _three_updates(make_optimizer(**kw), p_dev, names, False)
    s_host = _three_updates(make_optimizer(**kw), p_host, names, True)
    for a, b in zip(p_dev, p_host):
        assert torch.equal(a, b)
    _assert_equal(s_dev, s_host)
    assert s_dev.count == s_host.count == 3


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_apply_per_group_equals_update_list(moment_dtype):
    """`apply` (each moment group added to its params in place, its grads
    dropped) equals the full-list path (`update`, then p + u for every
    param) bitwise, over two steps, with clipping active and bf16 params."""
    kw = dict(learning_rate=1e-2, total_steps=10, warmup_steps=1,
              moment_dtype=moment_dtype, max_grad_norm=0.5, seed=1)
    pa, names = _leaves(dtype=torch.bfloat16)
    pb, _ = _leaves(dtype=torch.bfloat16)
    ta, tb = make_optimizer(**kw), make_optimizer(**kw)
    sa, sb = ta.init(pa, names), tb.init(pb, names)
    for step in range(2):
        updates, sa = ta.update(_grads(pa, step), sa, pa)
        for p, u in zip(pa, updates):
            p.add_(u.to(p.dtype))
        grads = _grads(pb, step)
        sb = tb.apply(grads, sb, pb)
        assert all(g is None for g in grads)   # every group's grads dropped
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    _assert_equal(sa, sb)


def test_group_stream_passes_cpu_items_through():
    items = [[torch.arange(4.0)], [torch.ones(3), torch.zeros(2)]]
    stream = GroupStream(items, "cpu")
    assert not stream.host
    got = stream.get(1)
    assert got[0] is items[1][0]
    stream.put(1, [torch.full((3,), 2.0), torch.ones(2)])
    out = stream.finish()
    assert torch.equal(out[1][0], torch.full((3,), 2.0))
    assert out[0][0] is items[0][0]


@pytest.mark.gpu
@pytest.mark.parametrize("moment_dtype", ("int8", "float32"))
def test_offload_streams_on_the_card_bitwise(moment_dtype):
    """On the card: the offloaded state is in a registered host arena, the
    update streams it through the card and back, and params and moments
    equal the on-device run bitwise; so does an accumulated mini-step with
    the accumulator offloaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    kw = dict(learning_rate=1e-3, total_steps=10, moment_dtype=moment_dtype,
              max_grad_norm=0.5, seed=3)
    p_dev, names = _leaves("cuda", torch.bfloat16)
    p_host, _ = _leaves("cuda", torch.bfloat16)
    s_dev = _three_updates(make_optimizer(**kw), p_dev, names, False)
    s_host = _three_updates(make_optimizer(**kw), p_host, names, True)
    host = offload_to_host(s_host)
    assert is_on_host(host) and all(t.is_pinned() for t in _flat(host))
    for a, b in zip(p_dev, p_host):
        assert torch.equal(a, b)
    _assert_equal(s_dev, host)
    ms = MultiSteps(make_optimizer(**kw), 2)
    a_dev = ms.apply(_grads(p_dev, 5), ms.init(p_dev, names), p_dev)
    a_host = ms.apply(_grads(p_host, 5),
                      offload_to_host(ms.init(p_host, names)), p_host)
    assert is_on_host(a_host)
    _assert_equal(a_dev, a_host)
    a_dev = ms.apply(_grads(p_dev, 6), a_dev, p_dev)
    a_host = ms.apply(_grads(p_host, 6), a_host, p_host)
    for a, b in zip(p_dev, p_host):
        assert torch.equal(a, b)
    _assert_equal(a_dev, a_host)
    assert np.isfinite(float(sum(p.float().sum() for p in p_host)))


def test_restore_into_keeps_the_host_tensors():
    """A restored state lands in the offloaded state's own tensors (the
    arena is allocated once); mismatched structures raise."""
    from spacer_tpu_torch.parallel.offload import restore_into

    params, names = _leaves()
    ms = MultiSteps(make_optimizer(learning_rate=1e-3, total_steps=10,
                                   moment_dtype="int8"), 2)
    state = offload_to_host(ms.init(params, names))
    saved = ms.apply(_grads(params, 0), ms.init(params, names), params)
    before = [id(t) for t in _flat(state)]
    back = restore_into(state, saved)
    assert [id(t) for t in _flat(back)] == before
    assert back.mini_step == 1
    _assert_equal(back, saved)
    with pytest.raises(ValueError):
        restore_into(state, make_optimizer().init(params, names))
