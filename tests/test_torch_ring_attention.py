"""Ring attention (spacer_tpu_torch/ops/ring_attention.py) against the JAX
package on the same numpy inputs, float32 on the CPU.

- In one process: the backward from given statistics
  (`attention_bwd_from_stats`) equals autograd through the plain attention
  at a block's own statistics; the ring's pieces (block forward, LSE merge,
  block backward under the merged statistics) over 2 and 4 emulated shards
  equal `xla_attention` over the whole sequence in values and gradients
  (causal and not, GQA, a left-padded kv_mask); the ring at a world of one
  is the plain attention exactly; the impl tuple's dispatch.
- gloo worlds of 2 and 4 (parallel.multihost.launch_local) over
  create_mesh({"fsdp": n}): `make_ring_attention` against JAX's
  make_ring_attention and xla_attention (values 2e-5 on live rows,
  gradients rtol 2e-4 / atol 2e-5, tests/test_ring_attention.py's), the
  LM forward with the ring tuple against JAX's (tests/
  test_ring_lm_forward.py's tolerances) and the packed GRPO step with the
  ring against JAX's (tests/test_ring_train_step.py's).
- The ring through the Qwen ViTs (Qwen2.5-VL's full-attention blocks,
  every Qwen2-VL block) at world 2: `vit_forward` and its parameter
  gradients against JAX's vit_forward with ("ring", mesh, axis) (2e-5;
  gradients rtol 5e-4 / atol 5e-6), and a packed GRPO step on a video
  prompt with the ring against JAX's (the text step's tolerances); at a
  world of one the ring through the ViT equals the K4 path.

Rows that see no key are compared nowhere: the ring leaves them
unspecified where JAX gives the mean of V (ROADMAP queue C); the losses
weight them 0.  The workers import only torch, numpy and spacer_tpu_torch.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spacer_tpu_torch.nn.attention import visible, xla_attention
from spacer_tpu_torch.ops import flash_attention as fa
from spacer_tpu_torch.ops import ring_attention as ra
from spacer_tpu_torch.parallel import multihost

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
B, S, H, HKV, D = 2, 128, 4, 2, 32
PAD = 9
LM_B, LM_S = 2, 32
P_LEN, C, G = 64, 16, 8
TIMEOUT = 180


def _qkv(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, H, D)).astype(np.float32)
    k = rng.normal(size=(b, s, HKV, D)).astype(np.float32)
    v = rng.normal(size=(b, s, HKV, D)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[0, :PAD] = False
    return q, k, v, mask


def _live(q, k, mask, causal):
    """(B, S) rows that see at least one key."""
    q, k, mask = _t(q, k, mask)
    return visible(q, k, causal=causal, kv_mask=mask).any(-1).numpy()


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# -- one process -------------------------------------------------------------


@pytest.mark.parametrize("causal,masked,hkv", [
    (False, False, 2), (True, False, 2), (True, True, 2), (False, True, 4),
    (True, True, 1)])
def test_bwd_from_stats_equals_autograd_at_own_statistics(causal, masked,
                                                          hkv):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 24, 4, 16)).astype(
        np.float32)) for _ in range(3))
    k, v = k[:, :, :hkv].contiguous(), v[:, :, :hkv].contiguous()
    mask = torch.ones(2, 24, dtype=torch.bool)
    if masked:
        mask[1, :5] = False
    live = visible(q, k, causal=causal, kv_mask=mask).any(-1)
    dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    dout = dout * live[:, :, None, None]    # dead rows get no gradient
    kw = dict(causal=causal, kv_mask=mask)
    out, lse = xla_attention(q, k, v, return_lse=True, **kw)
    delta = ra.delta_of(out, dout)
    got = fa.attention_bwd_from_stats(q, k, v, dout, lse, delta, **kw)
    want = fa.attention_bwd_reference(q, k, v, dout, **kw)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")
    # the public entries take the plain version on CPU tensors
    np.testing.assert_array_equal(
        fa.flash_attention_bwd_dq_from_stats(q, k, v, dout, lse, delta,
                                             **kw).numpy(), got[0].numpy())
    for a, b in zip(fa.flash_attention_bwd_dkv_from_stats(
            q, k, v, dout, lse, delta, **kw), got[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _emulated(q, k, v, mask, dout, n, causal):
    """The ring's pieces over n shards in one process -> (out, dq, dk, dv)."""
    s = q.shape[1] // n
    sl = lambda x, i: x[:, i * s:(i + 1) * s]  # noqa: E731
    outs, lses = [], []
    for r in range(n):
        out = lse = None
        for src in range(n):
            blk = ra.block_forward(sl(q, r), sl(k, src), sl(v, src),
                                   q_index=r, k_index=src, causal=causal,
                                   kv_mask=sl(mask, src))
            if blk is not None:
                out, lse = ra.merge(out, lse, *blk)
        outs.append(out)
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
    delta = ra.delta_of(out, dout)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for r in range(n):
        for src in range(n):
            g = ra.block_backward(sl(q, r), sl(k, src), sl(v, src),
                                  sl(dout, r), lse[:, :, r * s:(r + 1) * s],
                                  delta[:, :, r * s:(r + 1) * s], q_index=r,
                                  k_index=src, causal=causal,
                                  kv_mask=sl(mask, src))
            if g is not None:
                sl(dq, r).add_(g[0])
                sl(dk, src).add_(g[1])
                sl(dv, src).add_(g[2])
    return out, dq, dk, dv


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_pieces_over_emulated_shards(n, causal):
    q, k, v, mask = _qkv(seed=n)
    live = _live(q, k, mask, causal)
    q, k, v, mask = _t(q, k, v, mask)
    dout = torch.from_numpy(np.random.default_rng(5).normal(
        size=q.shape).astype(np.float32)) * torch.from_numpy(live)[:, :, None,
                                                                    None]
    out, *grads = _emulated(q, k, v, mask, dout, n, causal)
    want = xla_attention(q, k, v, causal=causal, kv_mask=mask)
    np.testing.assert_allclose(out.numpy()[live], want.numpy()[live], **VAL)
    ref = fa.attention_bwd_reference(q, k, v, dout, causal=causal,
                                     kv_mask=mask)
    for a, b, name in zip(grads, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"d{name}",
                                   **GRAD)


def test_merge_of_dead_rows_is_finite():
    """LSE -1e30 (a row that sees no key in a block) weighs 0 beside a live
    block and merges with another dead block without NaN."""
    out_a = torch.ones(1, 2, 1, 4)
    out_b = torch.full((1, 2, 1, 4), 3.0)
    lse_a = torch.tensor([[[-1e30, 0.5]]])
    lse_b = torch.tensor([[[-1e30, -1e30]]])
    out, lse = ra.merge(*ra.merge(None, None, out_a, lse_a), out_b, lse_b)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out[0, 1].numpy(), 1.0)
    assert float(lse[0, 0, 1]) == 0.5


def test_world_of_one_ring_is_the_plain_attention():
    q, k, v, mask = _t(*_qkv(seed=3))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ra.ring_attention(q, k, v, causal=True, kv_mask=mask)
    want = xla_attention(q, k, v, causal=True, kv_mask=mask)
    assert torch.equal(out, want)
    live = torch.from_numpy(_live(*(x.detach().numpy() for x in (q, k)),
                                  mask.numpy(), True))
    dout = torch.randn(out.shape) * live[:, :, None, None]
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = fa.attention_bwd_reference(q, k, v, dout, causal=True, kv_mask=mask)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_impl_dispatch():
    """("ring", mesh, axis) is the one accepted impl; where the ring does
    not apply (a q_offset, Sq != Skv, segment ids) the call takes the
    device's path, as JAX's does."""
    from spacer_tpu_torch.nn.attention import dot_product_attention
    from spacer_tpu_torch.parallel.mesh import Mesh

    q, k, v, mask = _t(*_qkv(seed=4))
    mesh = Mesh({"fsdp": 1}, 0)
    for bad in ("xla", "pallas", ("ring", mesh), ("sp", mesh, "fsdp")):
        with pytest.raises(ValueError, match="attn_impl"):
            dot_product_attention(q, k, v, impl=bad)
    impl = ("ring", mesh, "fsdp")
    seg = torch.zeros(B, S, dtype=torch.int32)
    for kw in (dict(q_offset=4), dict(q_segment_ids=seg, kv_segment_ids=seg)):
        got = dot_product_attention(q, k, v, causal=True, impl=impl, **kw)
        assert torch.equal(got, xla_attention(q, k, v, causal=True, **kw))
    got = dot_product_attention(q[:, :8], k, v, impl=impl)
    assert torch.equal(got, xla_attention(q[:, :8], k, v))


def test_ep_refuses_the_ring():
    """The ring no longer refuses moe_impl "ep": check_attn_impl takes the
    ring tuple for an ep config (and still refuses a malformed one), and a
    world-of-one ring forward of a tiny Aria at a capacity factor that
    drops assignments is the plain forward, drops included
    (tests/test_torch_aria_pipeline_ring.py holds the worlds against JAX)."""
    import dataclasses

    import spacer_tpu_torch.ops.moe as moe
    from spacer_tpu_torch.models.aria import init_params, tiny_aria_config
    from spacer_tpu_torch.models.qwen25_vl.language import (
        check_attn_impl,
        lm_forward,
    )
    from spacer_tpu_torch.parallel.mesh import Mesh

    cfg = tiny_aria_config()
    text = dataclasses.replace(cfg.text, moe_impl="ep",
                               moe_capacity_factor=0.5)
    impl = ("ring", Mesh({"fsdp": 1}, 0), "fsdp")
    check_attn_impl(impl)
    with pytest.raises(ValueError, match="attn_impl"):
        check_attn_impl(("ring", impl[1]))
    model = init_params(dataclasses.replace(cfg, text=text), seed=0)["model"]
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        10, text.vocab_size, size=(2, 16)))
    mask = torch.ones(2, 16, dtype=torch.bool)
    mask[0, :3] = False
    saved, drops = moe.kept_expert_ffn, []

    def counted(fc1, fc2, xt, code, keep, *a):
        drops.append(int((~keep).sum()))
        return saved(fc1, fc2, xt, code, keep, *a)

    moe.kept_expert_ffn = counted
    try:
        with torch.no_grad():
            want = lm_forward(model, text, input_ids=ids, kv_mask=mask)[0]
            got = lm_forward(model, text, input_ids=ids, kv_mask=mask,
                             attn_impl=impl)[0]
    finally:
        moe.kept_expert_ffn = saved
    n = text.num_layers
    assert len(drops) == 2 * n and sum(drops) > 0
    assert drops[:n] == drops[n:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


# -- gloo worlds of 2 and 4 ----------------------------------------------------


def _text_batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(G, P_LEN + C))
    return {
        "input_ids": ids.astype(np.int32),
        "kv_mask": np.ones((G, P_LEN + C), bool),
        "position_ids": np.broadcast_to(
            np.arange(P_LEN + C)[None, None], (3, G, P_LEN + C)
        ).astype(np.int32),
        "completion_mask": np.ones((G, C), np.int32),
        "advantages": rng.normal(size=(G,)).astype(np.float32),
    }


def _lm_ids(vocab):
    rng = np.random.default_rng(0)
    return (rng.integers(10, vocab, size=(LM_B, LM_S)),
            np.random.default_rng(1).integers(10, vocab, size=(1, 16)))


# the ViT cases: a video of 2 frame chunks of 8 x 12 patches (96 tokens a
# chunk, which 2 and 4 ranks divide), per ViT arch
VIT_GRID = ((2, 8, 12),)
VIT_ARCHS = ("qwen2_5", "qwen2")


def _vit_inputs(cfg):
    """(pixel_values, packed GRPO batch of G rows of one video prompt)."""
    from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

    rng = np.random.default_rng(4)
    t, h, w = VIT_GRID[0]
    px = rng.normal(size=(t * h * w, cfg.vision.patch_dim)).astype(
        np.float32)
    n_video = t * h * w // cfg.vision.spatial_merge_unit
    prompt = ([10, 11, cfg.vision_start_token_id]
              + [cfg.video_token_id] * n_video
              + [cfg.vision_end_token_id, 20, 21])
    # left padding that makes the packed rows a multiple of 8 (the LM's
    # ring splits them too)
    pad = 8 - (len(prompt) + C) % 8
    P = len(prompt) + pad
    ids = np.array([[cfg.pad_token_id] * pad + prompt])
    mask = np.array([[0] * pad + [1] * len(prompt)])
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=np.array(VIT_GRID),
                                 attention_mask=mask)
    comp = rng.integers(10, cfg.text.vocab_size, size=(G, C))
    comp_pos = deltas.reshape(-1, 1) + P + np.arange(C)[None]
    batch = {
        "input_ids": np.concatenate([np.repeat(ids, G, 0), comp], 1),
        "kv_mask": np.concatenate([np.repeat(mask, G, 0),
                                   np.ones((G, C), np.int64)], 1).astype(bool),
        "position_ids": np.concatenate([
            np.repeat(pos, G, 1),
            np.broadcast_to(comp_pos[None], (3, G, C))], 2),
        "completion_mask": np.ones((G, C), np.int32),
        "advantages": rng.normal(size=(G,)).astype(np.float32),
        "pixel_values": px,
    }
    return px, {k: (v.astype(np.int32) if k in ("input_ids", "position_ids")
                    else v) for k, v in batch.items()}


def _vit_torch_batch(batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(x))
           for k, x in batch.items()}
    for key in ("input_ids", "position_ids"):
        out[key] = out[key].long()
    return out


def _vit_ring(np_vit, mesh):
    """Per ViT arch: the ring ViT's output and visual-parameter gradients,
    and the packed GRPO step's metrics and params, over `mesh`'s fsdp."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax, tiny_config
    from spacer_tpu_torch.models.qwen25_vl.vision import (
        vision_layout,
        vit_forward,
    )
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    impl = ("ring", mesh, "fsdp")
    out = {}
    for arch in VIT_ARCHS:
        cfg = tiny_config(arch=arch)
        np_params = np_vit[arch]
        px, batch = _vit_inputs(cfg)
        params = params_from_jax(np_params, cfg)
        named = tstep.param_leaves(params["visual"])
        for _, t in named:
            t.requires_grad_(True)
        layout = vision_layout(VIT_GRID, cfg.vision)
        ve = vit_forward(params["visual"], cfg.vision, torch.from_numpy(px),
                         layout, attn_impl=impl)
        grads = torch.autograd.grad(torch.sin(ve).sum(),
                                    [t for _, t in named])
        params = params_from_jax(np_params, cfg)
        ref = params_from_jax(np_params, cfg)
        tx = make_optimizer(learning_rate=1e-3, total_steps=10)
        leaves = tstep.param_leaves(params)
        state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
        step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                          attn_impl=impl, logp_chunk=16)
        multihost.reset_collective_stats()
        params, _, m = step(params, ref, state, _vit_torch_batch(batch),
                            grid_thw=VIT_GRID, num_generations=G)
        out[arch] = {
            "ve": ve.detach().numpy(), "grads": [g.numpy() for g in grads],
            "metrics": {key: float(x) for key, x in m.items()},
            "params": [t.detach().numpy() for _, t in
                       tstep.param_leaves(params)],
            "names": [n for n, _ in tstep.param_leaves(params)],
            "stats": multihost.collective_stats()}
    return out


def _ring_worker(rank, out_dir, np_path):
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax, tiny_config
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    with open(np_path, "rb") as f:
        np_params = pickle.load(f)
    world = multihost.process_count()
    mesh = create_mesh({"fsdp": world})
    res = {}
    q, k, v, mask = _qkv()
    for causal in (False, True):
        ring = ra.make_ring_attention(mesh, "fsdp", causal=causal)
        res[f"out_{causal}"] = ring(*_t(q, k, v, mask)).numpy()
    ring = ra.make_ring_attention(mesh, "fsdp", causal=True)
    live = torch.from_numpy(_live(q, k, mask, True))[:, :, None, None]
    for tag, m, w in (("plain", None, 1.0), ("masked", mask, live)):
        qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
        out = ring(qt, kt, vt, None if m is None else torch.from_numpy(m))
        res[f"grads_{tag}"] = [g.numpy() for g in torch.autograd.grad(
            (torch.sin(out) * w).sum(), (qt, kt, vt))]
    multihost.reset_collective_stats()
    ring(*_t(q, k, v, mask))
    res["stats"] = multihost.collective_stats()

    cfg = tiny_config()
    impl = ("ring", mesh, "fsdp")
    ids, ids_g = _lm_ids(cfg.text.vocab_size)
    params = params_from_jax(np_params, cfg)
    res["lm"] = lm_forward(params["model"], cfg.text,
                           input_ids=torch.from_numpy(ids),
                           attn_impl=impl)[0].numpy()
    named = tstep.param_leaves(params["model"])
    for _, t in named:
        t.requires_grad_(True)
    out, _ = lm_forward(params["model"], cfg.text,
                        input_ids=torch.from_numpy(ids_g), attn_impl=impl)
    res["lm_grads"] = [g.numpy() for g in torch.autograd.grad(
        torch.tanh(out / 10.0).sum(), [t for _, t in named])]

    params = params_from_jax(np_params, cfg)
    ref = params_from_jax(np_params, cfg)
    tx = make_optimizer(learning_rate=1e-3, total_steps=10)
    leaves = tstep.param_leaves(params)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                      attn_impl=impl, logp_chunk=16)
    batch = {key: torch.from_numpy(np.ascontiguousarray(x))
             for key, x in _text_batch(cfg.text.vocab_size).items()}
    for key in ("input_ids", "position_ids"):
        batch[key] = batch[key].long()
    multihost.reset_collective_stats()
    params, _, m = step(params, ref, state, batch, num_generations=G)
    res["step_stats"] = multihost.collective_stats()
    res["metrics"] = {key: float(x) for key, x in m.items()}
    res["params"] = [t.detach().numpy() for _, t in
                     tstep.param_leaves(params)]
    if world == 2:
        with open(os.path.join(os.path.dirname(np_path), "vit.pkl"),
                  "rb") as f:
            res["vit"] = _vit_ring(pickle.load(f), mesh)
    results = multihost.all_gather_objects(res)
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(results, f)


def _jax_refs(np_params, n):
    """JAX's ring attention, ring LM forward and ring GRPO step over n CPU
    devices, and the single-device references."""
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import tiny_config
    from spacer_tpu.models.qwen25_vl.language import lm_forward
    from spacer_tpu.nn.attention import xla_attention as jax_xla
    from spacer_tpu.ops.ring_attention import make_ring_attention
    from spacer_tpu.train import make_optimizer as jax_make_optimizer
    from spacer_tpu.train.step import make_grpo_train_step

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("fsdp",))
    q, k, v, mask = (jnp.asarray(x) for x in _qkv())
    ref = {}
    with jax.default_matmul_precision("highest"):
        for causal in (False, True):
            ref[f"out_{causal}"] = np.asarray(jax.jit(make_ring_attention(
                mesh, "fsdp", causal=causal))(q, k, v, mask))
            ref[f"xla_{causal}"] = np.asarray(jax_xla(q, k, v, causal=causal,
                                                      kv_mask=mask))
        ring = make_ring_attention(mesh, "fsdp", causal=True)
        live = jnp.asarray(_live(*(np.asarray(x) for x in (q, k, mask)),
                                 True))[:, :, None, None]
        ref["grads_plain"] = jax.jit(jax.grad(
            lambda a, b, c: jnp.sum(jnp.sin(ring(a, b, c))), (0, 1, 2)))(
                q, k, v)
        ref["grads_masked"] = jax.jit(jax.grad(
            lambda a, b, c: jnp.sum(jnp.sin(ring(a, b, c, mask)) * live),
            (0, 1, 2)))(q, k, v)
        ref["grads_xla"] = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(
            jax_xla(a, b, c, causal=True))), (0, 1, 2))(q, k, v)

        cfg = tiny_config()
        params = jax.tree.map(jnp.asarray, np_params)
        impl = ("ring", mesh, "fsdp")
        ids, ids_g = (jnp.asarray(x) for x in _lm_ids(cfg.text.vocab_size))
        ref["lm"] = np.asarray(jax.jit(lambda p, i: lm_forward(
            p["model"], cfg.text, input_ids=i, causal=True,
            attn_impl=impl)[0])(params, ids))
        ref["lm_grads"] = jax.jit(jax.grad(lambda p: jnp.sum(jnp.tanh(
            lm_forward(p["model"], cfg.text, input_ids=ids_g, causal=True,
                       attn_impl=impl)[0] / 10.0))))(params)

        tx = jax_make_optimizer(learning_rate=1e-3, total_steps=10)
        step = make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                    attn_impl=impl, logp_chunk=16)
        p2, _, m = step(params, jax.tree.map(jnp.copy, params),
                        tx.init(params),
                        {key: jnp.asarray(x) for key, x in
                         _text_batch(cfg.text.vocab_size).items()},
                        grid_thw=None, num_generations=G, prompt_len=P_LEN)
    ref["metrics"] = {key: float(x) for key, x in m.items()}
    ref["params"] = jax.tree.map(np.asarray, p2)
    return ref


def _jax_vit_refs(np_vit, n):
    """JAX's ring ViT (output and visual-parameter gradients) and packed
    GRPO step on a video prompt over n CPU devices, per ViT arch."""
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import tiny_config
    from spacer_tpu.models.qwen25_vl.vision import (
        vision_layout,
        vit_forward,
    )
    from spacer_tpu.train import make_optimizer as jax_make_optimizer
    from spacer_tpu.train.step import make_grpo_train_step

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("fsdp",))
    impl = ("ring", mesh, "fsdp")
    out = {}
    for arch in VIT_ARCHS:
        cfg = tiny_config(arch=arch)
        params = jax.tree.map(jnp.asarray, np_vit[arch])
        px, batch = _vit_inputs(cfg)
        layout = vision_layout(VIT_GRID, cfg.vision)
        with jax.default_matmul_precision("highest"):
            fwd = jax.jit(lambda p, x: vit_forward(
                p, cfg.vision, x, layout, attn_impl=impl))
            ve = fwd(params["visual"], jnp.asarray(px))
            grads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(fwd(
                p, jnp.asarray(px))))))(params["visual"])
            tx = jax_make_optimizer(learning_rate=1e-3, total_steps=10)
            step = make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                        attn_impl=impl, logp_chunk=16)
            p2, _, m = step(params, jax.tree.map(jnp.copy, params),
                            tx.init(params),
                            {key: jnp.asarray(x) for key, x in batch.items()},
                            grid_thw=VIT_GRID, num_generations=G,
                            prompt_len=batch["input_ids"].shape[1] - C)
        out[arch] = {"ve": np.asarray(ve),
                     "grads": jax.tree.map(np.asarray, grads),
                     "metrics": {key: float(x) for key, x in m.items()},
                     "params": jax.tree.map(np.asarray, p2)}
    return out


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import init_params, tiny_config

    root = tmp_path_factory.mktemp("ring")
    np_params = jax.tree.map(np.asarray, init_params(
        jax.random.key(0), tiny_config(), jnp.float32))
    np_path = root / "params.pkl"
    with open(np_path, "wb") as f:
        pickle.dump(np_params, f)
    np_vit = {arch: jax.tree.map(np.asarray, init_params(
        jax.random.key(1), tiny_config(arch=arch), jnp.float32))
        for arch in VIT_ARCHS}
    with open(root / "vit.pkl", "wb") as f:
        pickle.dump(np_vit, f)

    def launch(world):
        d = root / str(world)
        d.mkdir()
        multihost.launch_local(_ring_worker, world,
                               args=(str(d), str(np_path)), device="cpu",
                               timeout=TIMEOUT, threads=1)
        with open(d / "result.pkl", "rb") as f:
            return pickle.load(f)

    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(launch, w) for w in (2, 4)}
        refs = {w: _jax_refs(np_params, w) for w in (2, 4)}
        refs["vit"] = _jax_vit_refs(np_vit, 2)
        runs = {w: f.result() for w, f in futures.items()}
    return runs, refs, np_params


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_make_ring_attention_matches_jax(ring_runs, world, causal):
    runs, refs, _ = ring_runs
    q, k, _, mask = _qkv()
    live = _live(q, k, mask, causal)
    ref = refs[world]
    for r in runs[world]:
        got = r[f"out_{causal}"]
        np.testing.assert_allclose(got[live], ref[f"out_{causal}"][live],
                                   **VAL)
        np.testing.assert_allclose(got[live], ref[f"xla_{causal}"][live],
                                   **VAL)
    stats = runs[world][0]["stats"]
    assert stats["ring_p2p"]["calls"] == world - 1, stats
    assert stats["ring_all_gather"]["calls"] == 1, stats


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["plain", "masked"])
def test_ring_attention_gradients_match_jax(ring_runs, world, tag):
    runs, refs, _ = ring_runs
    ref = refs[world]
    for r in runs[world]:
        for a, b, c, name in zip(r[f"grads_{tag}"], ref[f"grads_{tag}"],
                                 ref["grads_xla"], "qkv"):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"d{name}",
                                       **GRAD)
            if tag == "plain":
                np.testing.assert_allclose(a, np.asarray(c),
                                           err_msg=f"d{name}", **GRAD)


def _port_leaves(np_tree, cfg):
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.train.step import param_leaves

    return [t.numpy() for _, t in param_leaves(params_from_jax(np_tree, cfg))]


@pytest.mark.parametrize("world", WORLDS)
def test_ring_lm_forward_matches_jax(ring_runs, world):
    import jax

    from spacer_tpu_torch.models.qwen25_vl import tiny_config

    runs, refs, _ = ring_runs
    cfg = tiny_config()
    ref = refs[world]
    want = _port_leaves({"model": jax.tree.map(np.asarray,
                                               ref["lm_grads"]["model"])},
                        cfg)
    for r in runs[world]:
        np.testing.assert_allclose(r["lm"], ref["lm"], rtol=2e-5, atol=2e-5)
        for a, b in zip(r["lm_grads"], want):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_grpo_step_matches_jax(ring_runs, world):
    from spacer_tpu_torch.models.qwen25_vl import tiny_config

    runs, refs, _ = ring_runs
    ref = refs[world]
    want = _port_leaves(ref["params"], tiny_config())
    for r in runs[world]:
        m = r["metrics"]
        np.testing.assert_allclose(m["loss"], ref["metrics"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["kl"], 0.0, atol=1e-6)
        np.testing.assert_allclose(m["grad_norm"],
                                   ref["metrics"]["grad_norm"], rtol=1e-4)
        for a, b in zip(r["params"], want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-5)
    # the prompt rows' attention went around the ring in every layer
    stats = runs[world][0]["step_stats"]
    assert stats["ring_p2p"]["calls"] > 0 and stats["ring_all_gather"][
        "calls"] > 0, stats


@pytest.mark.parametrize("arch", VIT_ARCHS)
def test_ring_vit_matches_jax(ring_runs, arch):
    """The ViT's full-attention blocks through the ring over 2 ranks: the
    merged embeddings and every visual parameter's gradient against JAX's
    vit_forward with the ring tuple, on every rank."""
    import jax

    from spacer_tpu_torch.models.qwen25_vl import tiny_config

    runs, refs, _ = ring_runs
    ref = refs["vit"][arch]
    cfg = tiny_config(arch=arch)
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.train.step import param_leaves

    want = [t.numpy() for _, t in param_leaves(params_from_jax(
        {"visual": jax.tree.map(np.asarray, ref["grads"])}, cfg)["visual"])]
    for r in runs[2]:
        got = r["vit"][arch]
        np.testing.assert_allclose(got["ve"], ref["ve"], **VAL)
        # each element within 5e-4 of itself plus 5e-6 of its tensor's
        # largest (summation order over the blocks' sums of products)
        for a, b in zip(got["grads"], want):
            np.testing.assert_allclose(a, b, rtol=5e-4,
                                       atol=5e-6 * np.abs(b).max())


@pytest.mark.parametrize("arch", VIT_ARCHS)
def test_ring_vit_grpo_step_matches_jax(ring_runs, arch):
    """A packed GRPO step on a video prompt with the ring in the LM and the
    ViT over 2 ranks against JAX's step with the ring tuple (the text
    step's tolerances, with tests/test_torch_fsdp_trainer.py's
    _close_params allowance: Adam divides each element by its own
    gradient scale, so an element whose gradient sits at the summation
    noise may move by up to two learning rates: at most 1e-3 of a tensor's
    elements (at least 2) may)."""
    from spacer_tpu_torch.models.qwen25_vl import tiny_config

    runs, refs, _ = ring_runs
    ref = refs["vit"][arch]
    want = _port_leaves(ref["params"], tiny_config(arch=arch))
    for r in runs[2]:
        got = r["vit"][arch]
        m = got["metrics"]
        np.testing.assert_allclose(m["loss"], ref["metrics"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"],
                                   ref["metrics"]["grad_norm"], rtol=1e-4)
        for a, b, name in zip(got["params"], want, got["names"]):
            diff = np.abs(a - b)
            assert diff.max() <= 2 * 1e-3 + 1e-6, name
            off = (diff > 5e-5 + 1e-3 * np.abs(b)).sum()
            assert off <= max(2, diff.size // 1000), (name, off)
        assert got["stats"]["ring_p2p"]["calls"] > 0


@pytest.mark.parametrize("arch", VIT_ARCHS)
def test_ring_vit_at_world_one_is_the_chunk_path(arch):
    """At a world of one the ring through the ViT is K1 over each whole
    chunk (the plain attention on the CPU): the K4 path's output."""
    from spacer_tpu_torch.models.qwen25_vl import tiny_config
    from spacer_tpu_torch.models.qwen25_vl.model import init_params
    from spacer_tpu_torch.models.qwen25_vl.vision import (
        vision_layout,
        vit_forward,
    )
    from spacer_tpu_torch.parallel.mesh import Mesh

    cfg = tiny_config(arch=arch)
    params = init_params(cfg, seed=2)["visual"]
    px, _ = _vit_inputs(cfg)
    layout = vision_layout(VIT_GRID, cfg.vision)
    ring = ("ring", Mesh({"fsdp": 1}, 0), "fsdp")
    calls = []
    block = ra.block_forward
    try:
        ra.block_forward = lambda *a, **k: calls.append(1) or block(*a, **k)
        got = vit_forward(params, cfg.vision, torch.from_numpy(px), layout,
                          attn_impl=ring)
    finally:
        ra.block_forward = block
    want = vit_forward(params, cfg.vision, torch.from_numpy(px), layout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **VAL)
    assert len(calls) == len(cfg.vision.fullatt_block_indexes)
    # a chunk of 96 tokens over 7 ranks (the group is never reached)
    seven = Mesh({"fsdp": 7}, 0, groups={"fsdp": None})
    with pytest.raises(ValueError, match="does not divide"):
        vit_forward(params, cfg.vision, torch.from_numpy(px), layout,
                    attn_impl=("ring", seven, "fsdp"))
