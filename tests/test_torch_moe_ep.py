"""Expert-parallel MoE (`moe_mlp_ep`): spacer_tpu_torch against
spacer_tpu's moe_mlp_ep on the same numpy weights and inputs, float32 on
the CPU, tolerance 1e-4 (tests/test_torch_moe.py's).

- One process: values and gradients (x, router, experts, shared experts)
  at capacity factor 8.0 (nothing drops) and 0.01 (the floor of 8 slots
  drops assignments: the kept set must be JAX's exactly), and the
  positions against JAX's one-hot cumsum.
- gloo worlds of 2 and 4 (parallel.multihost.launch_local) over (data,
  fsdp, tp) meshes, the experts placed by expert over fsdp, over data or
  over data x fsdp (moe_ep_axis), with the rows split within the ep group,
  replicated within it, split over data only, and overlapping (a prompt
  row two ranks both hold): each rank's values and gradients against
  JAX's single-device moe_mlp_ep on the global batch (which equals JAX's
  moe_mlp_ep with ep_axis "data" on a two-device mesh: the axis moves
  data, not values), and every tp rank's routes equal; under the ep axes
  other than fsdp also one int8-moment AdamW update of the placed layer,
  whose moments and params go to the world-1 layout and back bitwise.
- The placement refusals: fsdp not dividing E, experts not whole blocks,
  a missing row layout.

Router weights are drawn wide (normal 0.5) so no near-tie flips a top-k
choice between the packages.  The workers import only torch, numpy and
spacer_tpu_torch."""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spacer_tpu_torch.ops import moe
from spacer_tpu_torch.parallel import multihost

TOL = dict(atol=1e-4, rtol=1e-4)
D, I, E, K, SHARED = 64, 32, 8, 2, 2
ROWS, TOKENS = 4, 12
TIMEOUT = 120
# the worlds' capacity factor: C = 8 of 96 assignments over 8 experts drops
CF = 0.5


def _np_layer(seed=3):
    rng = np.random.default_rng(seed)

    def tn(shape, scale):
        return (np.clip(rng.normal(size=shape), -2, 2) * scale).astype(
            np.float32)

    return {
        "router": {"kernel": rng.normal(0, 0.5, (D, E)).astype(np.float32)},
        "experts": {"fc1": {"kernel": tn((E, D, 2 * I), D ** -0.5)},
                    "fc2": {"kernel": tn((E, I, D), I ** -0.5)}},
        "shared": {"gate_proj": {"kernel": tn((D, I * SHARED), D ** -0.5)},
                   "up_proj": {"kernel": tn((D, I * SHARED), D ** -0.5)},
                   "down_proj": {"kernel": tn((I * SHARED, D),
                                              (I * SHARED) ** -0.5)}},
    }


def _np_x(seed=1):
    return np.random.default_rng(seed).normal(
        size=(ROWS, TOKENS, D)).astype(np.float32)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(p):
    return [p["router"]["kernel"], p["experts"]["fc1"]["kernel"],
            p["experts"]["fc2"]["kernel"], p["shared"]["gate_proj"]["kernel"],
            p["shared"]["up_proj"]["kernel"],
            p["shared"]["down_proj"]["kernel"]]


def _jax_ep(params, x, cf, ep_axis=None):
    """JAX's moe_mlp_ep on one device (or, with `ep_axis`, jitted on a
    two-device mesh of that axis) -> (out, grads of x and the leaves of
    sum(out * w)), with w a fixed weight so every row counts."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from spacer_tpu.ops.moe import moe_mlp_ep as jax_moe_mlp_ep

    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    kw = dict(topk=K, capacity_factor=cf)
    ctx = contextlib.nullcontext()
    if ep_axis is not None:
        kw["ep_axis"] = ep_axis
        ctx = jax.sharding.set_mesh(jax.sharding.Mesh(
            np.array(jax.devices()[:2]), (ep_axis,)))

    def fwd(p, xx):
        return jax_moe_mlp_ep(p, xx, **kw)

    def loss(p, xx):
        return jnp.sum(fwd(p, xx) * jnp.asarray(w))

    p = jax.tree.map(jnp.asarray, params)
    with jax.default_matmul_precision("highest"), ctx:
        out = jax.jit(fwd)(p, jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    return (np.asarray(out), np.asarray(gx),
            [np.asarray(g) for g in _leaves(gp)], w)


def _jax_keep(params, x, cf):
    """JAX's kept assignments (the one-hot cumsum of moe_mlp_ep)."""
    xt = x.reshape(-1, D)
    logits = xt @ params["router"]["kernel"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :K].reshape(-1)
    oh = np.eye(E)[idx]
    pos = ((np.cumsum(oh, axis=0) - 1) * oh).sum(-1)
    C = moe.moe_capacity(xt.shape[0], K, E, cf)
    return pos, pos < C


@pytest.mark.parametrize("cf", [8.0, 0.01])
def test_moe_mlp_ep_matches_jax(cf):
    params, x = _np_layer(), _np_x()
    ref_out, ref_gx, ref_gp, w = _jax_ep(params, x, cf)
    p = _torch(params)
    for t in _leaves(p):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_mlp_ep(p, xt, topk=K, capacity_factor=cf)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [xt, *_leaves(p)])
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **TOL)
    np.testing.assert_allclose(grads[0].numpy(), ref_gx, **TOL)
    for g, r in zip(grads[1:], ref_gp):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    pos, keep = _jax_keep(params, x, cf)
    _, idx = moe.route_topk(p["router"]["kernel"].detach(),
                            torch.from_numpy(x.reshape(-1, D)), K)
    got = moe.expert_positions(idx.reshape(-1), E)
    np.testing.assert_array_equal(got.numpy(), pos)
    if cf < 1:
        # the floor of 8 slots drops: a real keep set, not all or none
        assert 0 < keep.sum() < keep.size
        # a token whose assignments all dropped gets the shared output only
        shared = moe.shared_expert_mlp(
            p["shared"], torch.from_numpy(x.reshape(-1, D))).detach().numpy()
        gone = ~keep.reshape(-1, K).any(axis=1)
        assert gone.any()
        np.testing.assert_allclose(ref_out.reshape(-1, D)[gone],
                                   shared[gone], **TOL)
    else:
        assert keep.all()


# -- gloo worlds of 2 and 4 ----------------------------------------------------

# (name, mesh shape, row layout[, ep axis]): "split" over data x fsdp,
# "data" over data only, "repl" every rank all rows, or explicit ranges per
# batch index; the ep axis is fsdp unless named
CASES = {
    2: [("split_f2", {"fsdp": 2}, "split"),
        ("repl_f2", {"fsdp": 2}, "repl"),
        ("overlap_f2", {"fsdp": 2}, ((0, 2), (1, 4))),
        ("tp2", {"tp": 2}, "repl"),
        ("ep_data_d2", {"data": 2}, "split", "data"),
        ("ep_data_d2_repl", {"data": 2}, "repl", "data")],
    4: [("split_f4", {"fsdp": 4}, "split"),
        ("split_f2_tp2", {"fsdp": 2, "tp": 2}, "split"),
        ("split_d2_f2", {"data": 2, "fsdp": 2}, "split"),
        ("data_d2_f2", {"data": 2, "fsdp": 2}, "data"),
        ("tp4", {"tp": 4}, "repl"),
        ("ep_data_d2_f2", {"data": 2, "fsdp": 2}, "split", "data"),
        ("ep_data_d2_f2_rows_data", {"data": 2, "fsdp": 2}, "data", "data"),
        ("ep_data_d2_tp2", {"data": 2, "tp": 2}, "split", ("data",)),
        ("ep_batch_d2_f2", {"data": 2, "fsdp": 2}, "split",
         ("data", "fsdp")),
        ("ep_batch_d4", {"data": 4}, "overlap4", ("data", "fsdp"))],
}


def _layout(spec, mesh):
    from spacer_tpu_torch.parallel import expert

    if spec == "split":
        return expert.split_layout(ROWS, mesh, ("data", "fsdp"))
    if spec == "data":
        return expert.split_layout(ROWS, mesh, ("data",))
    if spec == "repl":
        return expert.RowLayout(ROWS)
    if spec == "overlap4":
        return expert.RowLayout(ROWS, ((0, 2), (1, 3), (2, 4), (3, 4)))
    return expert.RowLayout(ROWS, spec)


def _place_layer(np_layer, mesh, ep_axis="fsdp"):
    from spacer_tpu_torch.parallel.partition import (
        ARIA_EXPERT_LEAVES,
        ARIA_PARTITION_RULES,
        ARIA_TP_LEAVES,
        TPPlan,
        shard_params,
    )

    from spacer_tpu_torch.parallel.expert import ep_axes

    tree = {"model": {"layers": [{"mlp": _torch(np_layer)}]}}
    plan = TPPlan(ARIA_TP_LEAVES, {}, experts=ARIA_EXPERT_LEAVES,
                  ep_axes=ep_axes(ep_axis))
    return shard_params(tree, mesh, ARIA_PARTITION_RULES, plan)[0]


def _run_case(spec, shape, np_layer, x, w, ep_axis="fsdp"):
    """This rank's out and x grad of its rows, and (rank 0) every leaf's
    full gradient of the global loss sum(out * w); under an ep axis other
    than fsdp, the int8-moment round trip to the world-1 layout."""
    from spacer_tpu_torch.parallel import expert, fsdp, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.train.step import param_leaves

    mesh = create_mesh(shape)
    tree = _place_layer(np_layer, mesh, ep_axis)
    layout = _layout(spec, mesh)
    lo, hi = layout.range(mesh.batch_index)
    holders = np.zeros(ROWS)
    for b in range(mesh.shape["data"] * mesh.shape["fsdp"]):
        a, z = layout.range(b)
        holders[a:z] += 1
    named = param_leaves(tree)
    for _, t in named:
        t.requires_grad_(True)
    xl = torch.from_numpy(x[lo:hi].copy()).requires_grad_(True)
    routes = []
    route = moe.route_topk

    def recording(*a, **k):
        out = route(*a, **k)
        routes.append(out[1].clone())
        return out

    moe.route_topk = recording
    try:
        with expert.rows(layout):
            layer = fsdp.gather(tree["model"]["layers"][0])
            out = moe.moe_mlp(layer["mlp"], xl, topk=K, impl="ep",
                              capacity_factor=CF, ep_axis=ep_axis,
                              widths=(I, I * SHARED))
    finally:
        moe.route_topk = route
    weight = torch.from_numpy((w[lo:hi] / holders[lo:hi, None, None]
                               ).astype(np.float32))
    grads = list(torch.autograd.grad((out * weight).sum(),
                                     [xl] + [t for _, t in named]))
    gx, grads = grads[0], grads[1:]
    raw = fsdp.raw_leaves(tree)
    fsdp.reduce_replicated(grads, raw, mesh)
    full = [fsdp.Shard(g, leaf.shape, leaf.mesh, leaf.split,
                       leaf.experts).unsplit()
            if isinstance(leaf, fsdp.Shard) else g
            for g, leaf in zip(grads, raw)]
    round_trip = None if ep_axis == "fsdp" else _round_trip(tree, grads)
    # every tp rank picked the same routes
    tp_routes = multihost.all_gather_objects(routes[0].numpy(),
                                             mesh.group("tp"))
    assert all(np.array_equal(r, tp_routes[0]) for r in tp_routes)
    tp.set_mesh(None)
    return {"rows": (lo, hi), "out": out.detach().numpy(),
            "gx": gx.numpy(), "grads": [g.numpy() for g in full],
            "round_trip": round_trip,
            "names": [n for n, _ in named],
            "kinds": {k: v["calls"] for k, v in
                      multihost.collective_stats().items()
                      if k.startswith("ep_")}}


def _round_trip(tree, grads):
    """One int8-moment AdamW update of the placed layer, then its moments
    and params to the world-1 layout and back: whether the round trip is
    bitwise, and the norm (every Shard counted once over its group)."""
    from spacer_tpu_torch.parallel import fsdp
    from spacer_tpu_torch.train.optimizer import make_optimizer
    from spacer_tpu_torch.train.step import param_leaves

    leaves = [t for _, t in param_leaves(tree)]
    tx = make_optimizer(learning_rate=1e-3, total_steps=10,
                        moment_dtype="int8", sr_impl="off")
    state = tx.init(leaves, [n for n, _ in param_leaves(tree)],
                    blocks=fsdp.shard_blocks(tree))
    with torch.no_grad():
        _, state = tx.update(grads, state, leaves)
    full = fsdp.state_to_full(state, tree)
    back = fsdp.state_from_full(full, tree)
    same = all(torch.equal(a, b) for pa, pb in zip(state.mu + state.nu,
                                                   back.mu + back.nu)
               for a, b in zip(pa, pb))
    params = fsdp.params_from_full(fsdp.full_params(tree), tree)
    same = same and all(torch.equal(a.data, b.data) for a, b in zip(
        fsdp.raw_leaves(params), fsdp.raw_leaves(tree))
        if isinstance(a, fsdp.Shard))
    norm = fsdp.global_norm(grads, fsdp.raw_leaves(tree), tree["model"][
        "layers"][0]["mlp"]["experts"]["fc1"]["kernel"].mesh)
    return {"bitwise": same, "norm": float(norm)}


def _ep_worker(rank, out_dir, np_path):
    with open(np_path, "rb") as f:
        np_layer, x, w = pickle.load(f)
    world = multihost.process_count()
    res = {}
    for name, shape, spec, *axis in CASES[world]:
        multihost.reset_collective_stats()
        res[name] = _run_case(spec, shape, np_layer, x, w, *axis)
    results = multihost.all_gather_objects(res)
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(results, f)


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep")
    np_layer, x = _np_layer(), _np_x()
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    np_path = root / "inputs.pkl"
    with open(np_path, "wb") as f:
        pickle.dump((np_layer, x, w), f)

    def launch(world):
        d = root / str(world)
        d.mkdir()
        multihost.launch_local(_ep_worker, world, args=(str(d), str(np_path)),
                               device="cpu", timeout=TIMEOUT, threads=1)
        with open(d / "result.pkl", "rb") as f:
            return pickle.load(f)

    with ThreadPoolExecutor(2) as pool:
        runs = dict(zip((2, 4), pool.map(launch, (2, 4))))
    ref = _jax_ep(np_layer, x, CF)
    # JAX's moe_mlp_ep with ep_axis "data" on a two-device mesh: the same
    # values (the axis is a sharding constraint)
    meshed = _jax_ep(np_layer, x, CF, ep_axis="data")
    for a, b in zip((ref[0], ref[1], *ref[2]), (meshed[0], meshed[1],
                                               *meshed[2])):
        np.testing.assert_allclose(a, b, **TOL)
    return runs, ref


@pytest.mark.parametrize("world,name", [(w, c[0]) for w in CASES
                                        for c in CASES[w]])
def test_moe_mlp_ep_across_ranks_matches_jax(ep_runs, world, name):
    """Every rank's rows against JAX's global moe_mlp_ep at a capacity that
    drops assignments (the global keep set must be JAX's), and every leaf's
    full gradient."""
    runs, (ref_out, ref_gx, ref_gp, _) = ep_runs
    params, x = _np_layer(), _np_x()
    _, keep = _jax_keep(params, x, CF)
    assert not keep.all()
    ranks = [r[name] for r in runs[world]]
    gx = np.zeros_like(ref_gx)
    for r in ranks:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["out"], ref_out[lo:hi], **TOL)
    # the x gradient of a row is the sum over the batch group's holders (at
    # one tp index: tp is the fastest axis)
    tp_size = CASES_SHAPES[name].get("tp", 1)
    for i, r in enumerate(ranks):
        if i % tp_size == 0:
            lo, hi = r["rows"]
            gx[lo:hi] += r["gx"]
    np.testing.assert_allclose(gx, ref_gx, **TOL)
    grads = dict(zip(ranks[0]["names"], ranks[0]["grads"]))
    for path, ref in zip(("router", "experts/fc1", "experts/fc2",
                          "shared/gate_proj", "shared/up_proj",
                          "shared/down_proj"), ref_gp):
        got = grads[f"model/layers/0/mlp/{path}/kernel"]
        np.testing.assert_allclose(got, ref, **TOL)
    kinds = ranks[0]["kinds"]
    assert kinds, "no ep collective counted"
    trip = ranks[0]["round_trip"]
    if trip is not None:
        assert all(r["round_trip"]["bitwise"] for r in ranks)
        want = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                           for g in ranks[0]["grads"]))
        for r in ranks:
            assert r["round_trip"]["norm"] == pytest.approx(want, rel=1e-5)


CASES_SHAPES = {c[0]: c[1] for w in CASES for c in CASES[w]}


def test_placement_refusals():
    """fsdp not dividing E, experts that are not whole blocks, and a batch
    group with no row layout raise."""
    from spacer_tpu_torch.parallel import expert
    from spacer_tpu_torch.parallel.mesh import Mesh

    layer = _np_layer()
    with pytest.raises(ValueError, match="does not divide the 8 experts"):
        _place_layer(layer, Mesh({"fsdp": 3}, 0))
    with pytest.raises(ValueError, match="not whole"):
        _place_layer(layer, Mesh({"fsdp": 8, "tp": 2}, 0))
    tree = _place_layer(layer, Mesh({"fsdp": 2}, 0))
    fc1 = tree["model"]["layers"][0]["mlp"]["experts"]["fc1"]["kernel"]
    fc2 = tree["model"]["layers"][0]["mlp"]["experts"]["fc2"]["kernel"]
    assert expert.is_placed(fc1) and fc1.data.shape[0] == 4 * D * 2 * I // 2048
    scores, idx = moe.route_topk(torch.from_numpy(layer["router"]["kernel"]),
                                 torch.zeros(TOKENS, D), K)
    with pytest.raises(RuntimeError, match="parallel.expert.rows"):
        expert.routed_ep(fc1, fc2, torch.zeros(TOKENS, D), scores, idx, 2.0,
                         rows=1)


def test_k6_packing_at_aria_tp4_down_proj():
    """K6 takes K % 64 == 0: Aria's shared down_proj at tp 4 has K = 3328 /
    4 = 832, one K-block (832 is no multiple of 256) whose half pairs rows
    0-415 with 416-831.  The port's packed bytes equal JAX's pack_int4, and
    K6's plain product equals the dequantized product."""
    import jax.numpy as jnp

    from spacer_tpu.ops.int4_matmul import pack_int4 as jax_pack_int4
    from spacer_tpu_torch.ops import int4_matmul as im

    rng = np.random.default_rng(8)
    codes = rng.integers(-8, 8, (832, 48)).astype(np.int8)
    assert im._block_k(832) == 832
    packed = im.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(im.unpack_int4(packed, 832).numpy(), codes)
    x = torch.from_numpy(rng.normal(size=(4, 832)).astype(np.float32))
    im._check(x.to(torch.bfloat16), packed)    # 832 % 64 == 0 passes
    np.testing.assert_allclose(
        im.int4_matmul_reference(x, packed).numpy(),
        x.to(torch.bfloat16).float().numpy() @ codes.astype(np.float32),
        rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="K % 64"):
        im._check(x[:, :800].to(torch.bfloat16), packed[:400])
