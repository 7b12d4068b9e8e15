"""Tensor parallelism's pieces on the CPU (parallel/tp.py, the tp axis of
parallel/mesh.py, the tp placement of parallel/partition.py, the decode
quantization under tp):

- the tp Mesh's coordinates and its five kinds of process groups against
  the positions of JAX's `create_mesh` on the conftest's 8 CPU devices;
- the tp placement of every leaf of both tiny Qwen configs (and of a
  config whose ViT qkv is stored split): each rank's slice, joined over the
  ranks, is the leaf bitwise, the ViT's fused qkv cut per q / k / v head;
- `copy_to_tp`, `reduce_from_tp`, `gather_from_tp`, the vocab-parallel
  embedding and logps and `local`'s slice of a whole leaf, forward and
  backward at a gloo world of 2, against their unsplit versions;
- int8 / int4 decode codes and scales at tp 2 equal to the slices of world
  1's (column- and row-parallel kernels), and so the packed int4 bytes;
- the GRPO gradients of the leaves kept whole over tp, bitwise the same on
  both ranks of a tp-2 world;
- the ValueError for a tp that does not divide the heads, and the Aria
  refusal at tp > 1 (ROADMAP queue A item 2b.2)."""

import os
import pickle

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import multihost
from spacer_tpu_torch.parallel import partition as tpart
from spacer_tpu_torch.parallel.mesh import Mesh, _axis_groups

TIMEOUT = 60


@pytest.mark.parametrize("shape", [
    {"data": 1, "fsdp": 2, "tp": 2}, {"data": 2, "fsdp": 1, "tp": 4},
    {"data": 2, "fsdp": 2, "tp": 2}, {"tp": 8}, {"data": 1, "fsdp": 4,
                                                 "tp": 2}])
def test_tp_mesh_coords_and_groups_match_jax(cpu_devices, shape):
    from spacer_tpu.parallel.mesh import create_mesh as jax_create_mesh

    n = int(np.prod(list(shape.values())))
    jmesh = jax_create_mesh(shape, devices=cpu_devices[:n])
    ranks = np.vectorize(cpu_devices.index)(jmesh.devices)   # (D, F, T)
    for idx in np.ndindex(ranks.shape):
        assert tuple(Mesh(shape, int(ranks[idx])).coords.values()) == idx
    D, F, T = ranks.shape

    def as_sets(lists):
        return sorted(sorted(int(r) for r in g) for g in lists)

    want = {
        "tp": [ranks[d, f, :] for d in range(D) for f in range(F)],
        "fsdp": [ranks[d, :, t] for d in range(D) for t in range(T)],
        "data": [ranks[:, f, t] for f in range(F) for t in range(T)],
        "batch": [ranks[:, :, t].reshape(-1) for t in range(T)],
        "model": [ranks[d].reshape(-1) for d in range(D)],
    }
    if D > 1 and T > 1:   # else create_mesh reuses the data or tp group
        want["data_tp"] = [ranks[:, f, :].reshape(-1) for f in range(F)]
    got = _axis_groups(Mesh(shape, 0).shape)
    assert set(got) == set(want)
    for name, lists in want.items():
        assert as_sets(got[name]) == as_sets(lists), name
    # a tp group is contiguous ranks (one NVLink host's cards)
    for g in got["tp"]:
        assert g == list(range(g[0], g[0] + T))


def _slices(params, shape, plan, rules):
    """Each rank's placed tree of `params` on a groupless Mesh."""
    n = int(np.prod(list(shape.values())))
    return [tpart.shard_params(params, Mesh(shape, r), rules, plan)[0]
            for r in range(n)]


def _local(leaf):
    """A placed leaf's tensor on its rank (fsdp 1: the Shard's blocks cut
    to the slice)."""
    from spacer_tpu_torch.parallel.fsdp import Shard

    if isinstance(leaf, Shard):
        return leaf.data.reshape(-1)[:leaf.numel].view(leaf.shape)
    return leaf


@pytest.mark.parametrize("arch,tp,qkv_split", [
    ("qwen2_5", 2, False), ("qwen2", 2, False), ("qwen2_5", 4, False),
    ("qwen2_5", 2, True), ("qwen2", 4, True)])
def test_tp_placement_joins_back_to_every_leaf(arch, tp, qkv_split):
    """Slice, then join over the tp ranks: every leaf bitwise.  With
    `qkv_split` the ViT is widened (hidden 64, 4 heads) so its per-layer
    qkv (64 x 192) is a multiple of 2048 and stored split."""
    import dataclasses

    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel.fsdp import Shard

    cfg = tiny_config(arch=arch)
    if tp == 4 or qkv_split:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, num_kv_heads=4),
            vision=dataclasses.replace(
                cfg.vision, num_heads=4,
                hidden_size=64 if qkv_split else cfg.vision.hidden_size))
    params = init_params(cfg, seed=0)
    plan = tpart.qwen_tp_plan(cfg)
    ranks = _slices(params, {"tp": tp}, plan, tpart.QWEN_PARTITION_RULES)
    named = [dict(tpart._named_leaves(r)) for r in ranks]
    split_paths = []
    for path, full in tpart._named_leaves(params):
        leaves = [n[path] for n in named]
        split = leaves[0].split if isinstance(leaves[0], Shard) else None
        if split is None:
            for leaf in leaves:
                torch.testing.assert_close(_local(leaf), full, rtol=0, atol=0)
            continue
        split_paths.append(path)
        assert [leaf.split.index for leaf in leaves] == list(range(tp))
        parts = [_local(leaf) for leaf in leaves]
        assert parts[0].shape == split.local_shape
        torch.testing.assert_close(split.join(parts), full, rtol=0, atol=0)
    # the plan's leaves are split (the tiny ViT's 32-wide qkv and proj stay
    # whole: per-layer tensors of a size no multiple of 2048)
    assert "model/layers/0/self_attn/q_proj/kernel" in split_paths
    assert "model/embed_tokens/embedding" in split_paths
    assert "model/lm_head/kernel" in split_paths
    assert "visual/merger/mlp_2/kernel" in split_paths
    assert ("visual/blocks/0/attn/qkv/kernel" in split_paths) == qkv_split
    assert not any(p.endswith("bias") or "patch_embed" in p
                   for p in split_paths)
    if qkv_split:
        # head-aware: rank t holds heads [t H/tp, (t + 1) H/tp) of each of
        # q, k and v
        D, H, Dh = cfg.vision.hidden_size, cfg.vision.num_heads, \
            cfg.vision.head_dim
        full = params["visual"]["blocks"][0]["attn"]["qkv"]["kernel"]
        h = H // tp
        for t, n in enumerate(named):
            got = _local(n["visual/blocks/0/attn/qkv/kernel"])
            want = full.reshape(D, 3, H, Dh)[:, :, t * h:(t + 1) * h]
            torch.testing.assert_close(got, want.reshape(D, 3 * h * Dh),
                                       rtol=0, atol=0)
        assert isinstance(n["visual/blocks/0/attn/qkv/kernel"], Shard)


def test_a_tp_that_does_not_divide_the_heads_raises():
    import dataclasses

    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel.tp import Split

    cfg = tiny_config()          # 4 heads, 2 KV heads, 2 ViT heads
    params = init_params(cfg, seed=0)
    with pytest.raises(ValueError, match="num_kv_heads=2"):
        tpart.shard_params(params, Mesh({"tp": 4}, 0),
                           tpart.QWEN_PARTITION_RULES,
                           tpart.qwen_tp_plan(cfg))
    wide = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_kv_heads=4))
    with pytest.raises(ValueError, match="ViT's num_heads=2"):
        tpart.shard_params(init_params(wide, seed=0), Mesh({"tp": 4}, 0),
                           tpart.QWEN_PARTITION_RULES,
                           tpart.qwen_tp_plan(wide))
    with pytest.raises(ValueError, match="tp plan"):
        tpart.shard_params(params, Mesh({"tp": 2}, 0),
                           tpart.QWEN_PARTITION_RULES)
    with pytest.raises(ValueError, match="does not divide q"):
        Split.make((64, 36), 1, 8, 0, what="q")


def test_aria_refuses_tp():
    """Aria's tp plan at tp 2 (its leaves and counts; moe_impl "ep" places
    the experts), and a ValueError at a tp that does not divide the heads
    (20 / 16 at ARIA_25B) or the expert intermediate (1664)."""
    import dataclasses

    from spacer_tpu_torch.models.aria import ARIA_25B
    from spacer_tpu_torch.models.registry import get_family

    aria = get_family("aria")
    plan = aria.tp_plan(aria.tiny_config(), 2)
    assert plan.leaves == tpart.ARIA_TP_LEAVES and plan.experts is None
    assert plan.kind("model/layers/3/mlp/experts/fc1/kernel") == "halves"
    assert plan.kind("model/layers/3/mlp/router/kernel") is None
    assert plan.kind("visual/encoder/0/self_attn/out_proj/kernel") == "split"
    assert plan.kind("projector/cross_attn/q_proj/kernel") is None
    for tp in (1, 2, 4):
        aria.tp_plan(ARIA_25B, tp)
    for tp, what in ((8, "num_heads=20"), (3, "num_heads=20")):
        with pytest.raises(ValueError, match=what):
            aria.tp_plan(ARIA_25B, tp)
    wide_heads = dataclasses.replace(
        ARIA_25B, text=dataclasses.replace(ARIA_25B.text, num_heads=40,
                                           num_kv_heads=40),
        vision=dataclasses.replace(ARIA_25B.vision, num_heads=40))
    with pytest.raises(ValueError, match="intermediate_size=1664"):
        aria.tp_plan(wide_heads, 5)
    ep = dataclasses.replace(ARIA_25B, text=dataclasses.replace(
        ARIA_25B.text, moe_impl="ep"))
    assert aria.tp_plan(ep, 2).placed("model/layers/0/mlp/experts/fc2/kernel")


# -- the conjugate operations at a gloo world of 2 --------------------------


def _ops_worker(rank, out_dir):
    from spacer_tpu_torch.nn.core import embed
    from spacer_tpu_torch.parallel import tp
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.train.grpo import per_token_logps_from_logits

    torch.manual_seed(0)
    x = torch.randn(3, 5, 8, dtype=torch.float64)
    w = torch.randn(8, 6, dtype=torch.float64)       # column-parallel
    w2 = torch.randn(6, 8, dtype=torch.float64)      # row-parallel
    table = torch.randn(10, 8, dtype=torch.float64)  # vocab 10
    head = torch.randn(8, 10, dtype=torch.float64)
    ids = torch.tensor([[0, 4, 5, 9, 3]])
    qkv_b = torch.randn(3 * 2 * 4, dtype=torch.float64)   # 3 x 2 heads x 4

    def run(split: bool):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, w, w2, table, head, qkv_b)]
        xl, wl, w2l, tl, hl, bl = leaves
        if split:
            t = tp.index()
            wl = wl[:, 3 * t:3 * t + 3]
            w2l = w2l[3 * t:3 * t + 3]
            tl = tl[5 * t:5 * t + 5]
            hl = hl[:, 5 * t:5 * t + 5]
        h = tp.copy_to_tp(xl)
        y = tp.reduce_from_tp(torch.tanh(h @ wl) @ w2l)
        logits = tp.gather_from_tp(tp.copy_to_tp(y) @ hl)
        e = embed({"embedding": tl}, ids)
        lp = (tp.vocab_logps((tp.copy_to_tp(e) @ hl).float(), ids) if split
              else per_token_logps_from_logits(e @ hl, ids))
        b = tp.local(bl, 0, 24, pre=3, post=4)
        coef = tp.local(torch.arange(24.0, dtype=torch.float64), 0, 24,
                        pre=3, post=4)
        loss = (y.square().sum() + logits.sin().sum() + lp.sum()
                + (b * coef).sum())
        loss.backward()
        grads = [g.grad for g in leaves]
        if split:
            # the sliced leaves' gradients: this rank's slice of the whole
            # one, all-gathered back to compare
            for i, (dim, n) in ((1, (1, 3)), (2, (0, 3)), (3, (0, 5)),
                                (4, (1, 5))):
                g = grads[i].narrow(dim, n * tp.index(), n)
                parts = [torch.empty_like(g) for _ in range(2)]
                torch.distributed.all_gather(parts, g.contiguous())
                grads[i] = torch.cat(parts, dim=dim)
        return (y.detach(), logits.detach(), e.detach(), lp.detach(),
                b.detach(), [g.clone() for g in grads])

    tp.set_mesh(None)
    ref = run(False)
    mesh = create_mesh({"tp": 2})
    tp.set_mesh(mesh)
    got = run(True)
    stats = {k: v["calls"] for k, v in
             multihost.collective_stats().items() if k.startswith("tp_")}
    if rank == 0:
        with open(os.path.join(out_dir, "ops.pkl"), "wb") as f:
            pickle.dump((ref, got, stats), f)


def test_conjugate_ops_forward_and_backward_at_world_two(tmp_path):
    multihost.launch_local(_ops_worker, 2, args=(str(tmp_path),),
                           device="cpu", timeout=TIMEOUT, threads=1)
    with open(tmp_path / "ops.pkl", "rb") as f:
        ref, got, stats = pickle.load(f)
    y, logits, e, lp, b, grads = got
    ry, rlogits, re, rlp, rb, rgrads = ref
    torch.testing.assert_close(y, ry, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(logits, rlogits, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(e, re, rtol=0, atol=0)   # one rank per row
    torch.testing.assert_close(lp.double(), rlp.double(), rtol=1e-6,
                               atol=1e-6)
    # rank 0's slice of the qkv bias: q, k and v's first head each
    torch.testing.assert_close(b, rb.reshape(3, 2, 4)[:, 0].reshape(-1),
                               rtol=0, atol=0)
    for g, rg in zip(grads[:5], rgrads[:5]):
        torch.testing.assert_close(g, rg, rtol=1e-5, atol=1e-6)
    # `local`'s gradient: the whole leaf's (both ranks' slices)
    torch.testing.assert_close(grads[5], rgrads[5], rtol=0, atol=0)
    assert stats["tp_all_reduce"] >= 4 and stats["tp_all_gather"] >= 2
    assert stats["tp_max"] == 1


# -- decode quantization under tp ----------------------------------------------


def _quant_worker(rank, out_dir):
    from spacer_tpu_torch.ops import quant
    from spacer_tpu_torch.parallel import tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    tp.set_mesh(create_mesh({"tp": 2}))
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(256, 96)).astype(np.float32))
    t = tp.index()
    out = {}
    for name, local in (("q_proj", w[:, 48 * t:48 * (t + 1)]),
                        ("o_proj", w[128 * t:128 * (t + 1)])):
        layer = {name: {"kernel": local.contiguous()}}
        out[name] = (quant.quantize_tree_int8([layer])[0][name],
                     quant.quantize_tree_int4([layer])[0][name])
    with open(os.path.join(out_dir, f"quant{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_decode_codes_and_scales_at_tp2_are_slices_of_world_one(tmp_path):
    from spacer_tpu_torch.ops import quant
    from spacer_tpu_torch.ops.int4_matmul import pack_int4, unpack_int4

    multihost.launch_local(_quant_worker, 2, args=(str(tmp_path),),
                           device="cpu", timeout=TIMEOUT, threads=1)
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(256, 96)).astype(np.float32))
    q8 = quant.quantize_dense_int8({"kernel": w})
    q4 = quant.quantize_dense_int4({"kernel": w})
    codes4 = unpack_int4(q4["kernel_q4"], 256)
    for t in range(2):
        with open(tmp_path / f"quant{t}.pkl", "rb") as f:
            got = pickle.load(f)
        cols, rows = slice(48 * t, 48 * (t + 1)), slice(128 * t, 128 * (t + 1))
        for name, sl in (("q_proj", (slice(None), cols)), ("o_proj", (rows,))):
            g8, g4 = got[name]
            torch.testing.assert_close(g8["kernel_q8"], q8["kernel_q8"][sl],
                                       rtol=0, atol=0)
            torch.testing.assert_close(
                g8["q8_scale"], q8["q8_scale"][(slice(None), cols)]
                if name == "q_proj" else q8["q8_scale"], rtol=0, atol=0)
            k = sl[0] if name == "o_proj" else slice(None)
            # the packed bytes: world 1's codes sliced, then packed
            torch.testing.assert_close(
                g4["kernel_q4"], pack_int4(codes4[sl]), rtol=0, atol=0)
            torch.testing.assert_close(g4["q4_row_scale"],
                                       q4["q4_row_scale"][k], rtol=0, atol=0)
            torch.testing.assert_close(
                g4["q4_col_scale"], q4["q4_col_scale"][cols]
                if name == "q_proj" else q4["q4_col_scale"], rtol=0, atol=0)


# -- gradients of the leaves kept whole over tp --------------------------------


def _replicated_grads_worker(rank, out_dir):
    import test_torch_fsdp_trainer as ft

    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel import fsdp
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    cfg = tiny_config()
    mesh = create_mesh({"tp": 2})
    params, _ = tpart.shard_params(init_params(cfg, seed=0), mesh,
                                   tpart.QWEN_PARTITION_RULES,
                                   tpart.qwen_tp_plan(cfg))
    step = tstep.make_grpo_train_step(cfg, make_optimizer(), beta=0.0,
                                      remat=False, logp_chunk=8, mesh=mesh)
    _, _, grads = step.loss_and_grads(
        params, None, ft._torch_batch(ft._step_batch(cfg)),
        ft.STEP_GRID * ft.STEP_B, ft.G)
    named = tstep.param_leaves(params)
    whole = {n: g for (n, _), g, leaf in zip(named, grads,
                                             fsdp.raw_leaves(params))
             if not (isinstance(leaf, fsdp.Shard) and leaf.split)}
    with open(os.path.join(out_dir, f"grads{rank}.pkl"), "wb") as f:
        pickle.dump({n: g.numpy() for n, g in whole.items()}, f)


def test_leaves_whole_over_tp_get_the_same_gradient_on_every_rank(tmp_path):
    """At tp 2 the gradient of every leaf kept whole on both tp ranks (the
    norms, the biases, patch_embed, the tiny ViT's qkv / proj kernels) is
    bitwise the same on both: the conjugate operations see to it, so the
    ranks' updates of those leaves never drift apart."""
    multihost.launch_local(_replicated_grads_worker, 2,
                           args=(str(tmp_path),), device="cpu",
                           timeout=TIMEOUT, threads=1)
    with open(tmp_path / "grads0.pkl", "rb") as f:
        g0 = pickle.load(f)
    with open(tmp_path / "grads1.pkl", "rb") as f:
        g1 = pickle.load(f)
    assert g0.keys() == g1.keys()
    assert "visual/patch_embed/proj/kernel" in g0
    assert "model/layers/0/self_attn/q_proj/bias" in g0
    assert "visual/blocks/0/attn/qkv/kernel" in g0
    for n in g0:
        np.testing.assert_array_equal(g0[n], g1[n], err_msg=n)
    assert any(np.abs(g).sum() > 0 for g in g0.values())
