"""Pipeline parallelism (spacer_tpu_torch/parallel/pipeline.py) against the
JAX package's, one counterpart for each test of tests/test_pipeline.py at
its tolerances, float32 on the CPU: the port's stages are gloo ranks
(parallel.multihost.launch_local), JAX's the conftest's CPU devices.

- world 4, create_mesh({"pipe": 4}): the forward at S = 4, M = 2; the
  gradient parity of a GRPO-style loss; the GRPO step; the SFT step; an
  AdamW update that leaves each stage holding only its layers;
- world 4, create_mesh({"pipe": 2, "data": 2}): pipe x data;
- world 2, create_mesh({"pipe": 2}): S = 2 with M = B.

In one process: a pipe axis of 1 leaves a mesh's coordinates and groups as
they were, pipe-major coordinates match JAX's ("pipe", "data") mesh, a
one-stage pipeline equals lm_forward bitwise, and the refusals (layers or
batch that do not divide, fsdp or tp beside a pipe, the shared-prefix
schema; moe_impl "ep" is taken).  The workers import only torch, numpy and
spacer_tpu_torch.

The steps run both packages' make_optimizer at learning rate 1e-3 with
Adam's eps at 1e-6, as tests/test_torch_train_step.py does: Adam divides
each element by its own gradient scale, so an element whose gradient is
f32 noise (~1e-8) would turn the two packages' summation orders into
updates of up to ~lr apart; eps 1e-6 damps such elements on both sides
alike, and the updated params keep test_pipeline.py's 2e-4.
"""

import dataclasses
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import multihost
from spacer_tpu_torch.parallel.mesh import Mesh, _axis_groups

TIMEOUT = 240
C_GRPO, G_GRPO, P_GRPO = 8, 8, 16


def _cfg(layers):
    from spacer_tpu_torch.models.qwen25_vl import tiny_config

    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_layers=layers))


def _data(B, T, seed=0, vocab=None):
    """test_pipeline.py's _setup inputs: ids, a left-padded mask, positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[0, :3] = False
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).astype(
        np.int32)
    return ids, mask, pos


def _adv(n, seed):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


# the cases: name -> (world, mesh shape, layers, B, T, M)
CASES = {
    "forward": (4, {"pipe": 4}, 4, 4, 24, 2),
    "grads": (4, {"pipe": 4}, 4, 4, 16, 2),
    "pipe_data": (4, {"pipe": 2, "data": 2}, 4, 8, 16, 2),
    "grpo": (4, {"pipe": 4}, 4, 8, 24, 2),
    "sft": (4, {"pipe": 4}, 4, 4, 16, 2),
    "update": (4, {"pipe": 4}, 4, 4, 16, 2),
    "single_stage_m_eq_b": (2, {"pipe": 2}, 2, 4, 16, 4),
}


def _grpo_like(logits, ids, adv, C):
    """test_pipeline.py's loss: advantage-weighted logp of the realized
    ids on the last C positions."""
    lp = torch.log_softmax(logits[:, -C - 1:-1].float(), -1)
    tok = torch.gather(lp, -1, ids[:, -C:, None].long())[..., 0]
    return -(adv[:, None] * tok).mean()


def _local_grads(names, grads, span):
    """{global path: numpy gradient} of a stage (layer j -> span[j])."""
    out = {}
    for n, g in zip(names, grads):
        parts = n.split("/")
        if parts[:2] == ["model", "layers"]:
            parts[2] = str(span[int(parts[2])])
        out["/".join(parts)] = g.detach().numpy()
    return out


def _run_case(name, np_params, mesh):
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.parallel.pipeline import (
        pipeline_lm_forward,
        shard_layers_for_pipeline,
        stage_layers,
    )
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    _, _, L, B, T, M = CASES[name]
    cfg = _cfg(L)
    ids, mask, pos = (torch.from_numpy(x.copy()) for x in
                      _data(B, T, vocab=cfg.text.vocab_size))
    ids, pos = ids.long(), pos.long()
    span = list(stage_layers(L, mesh))
    batch_axis = "data" if "data" in CASES[name][1] else None
    params = params_from_jax(np_params, cfg)
    params["model"] = shard_layers_for_pipeline(params["model"], mesh)
    fwd = dict(num_microbatches=M, input_ids=ids, position_ids=pos,
               kv_mask=mask, batch_axis=batch_axis)
    res = {"span": span}
    if name in ("forward", "pipe_data", "single_stage_m_eq_b"):
        with torch.no_grad():
            res["logits"] = pipeline_lm_forward(params["model"], cfg.text,
                                                mesh, **fwd).numpy()
    elif name == "grads":
        named = tstep.param_leaves(params["model"], "model/")
        for _, t in named:
            t.requires_grad_(True)
        logits = pipeline_lm_forward(params["model"], cfg.text, mesh, **fwd)
        loss = _grpo_like(logits, ids, torch.from_numpy(_adv(B, 3)), 6)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        res["loss"] = float(loss)
        res["grads"] = _local_grads([n for n, _ in named], grads, span)
    elif name in ("grpo", "sft"):
        tx = make_optimizer(learning_rate=1e-3, total_steps=10, eps=1e-6)
        leaves = tstep.param_leaves(params)
        state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
        if name == "grpo":
            ref = params_from_jax(np_params, cfg)
            ref["model"] = shard_layers_for_pipeline(ref["model"], mesh)
            step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                              logp_chunk=8,
                                              pipeline=(mesh, M))
            batch = {"input_ids": ids, "kv_mask": mask, "position_ids": pos,
                     "completion_mask": torch.ones(B, C_GRPO,
                                                   dtype=torch.int32),
                     "advantages": torch.from_numpy(_adv(B, 7))}
            multihost.reset_collective_stats()
            params, _, m = step(params, ref, state, batch,
                                num_generations=G_GRPO)
            res["stats"] = multihost.collective_stats()
        else:
            step = tstep.make_sft_train_step(cfg, tx, logp_chunk=8,
                                             pipeline=(mesh, M))
            batch = {"input_ids": ids, "kv_mask": mask, "position_ids": pos,
                     "labels": torch.where(mask, ids, -100)}
            params, _, m = step(params, state, batch)
        res["metrics"] = {k: float(v) for k, v in m.items()}
        res["params"] = _local_grads(*zip(*tstep.param_leaves(params)),
                                     span)
    else:   # update
        model = params["model"]
        named = tstep.param_leaves(model, "model/")
        before = [t.detach().clone() for _, t in named]
        for _, t in named:
            t.requires_grad_(True)
        logits = pipeline_lm_forward(model, cfg.text, mesh, **fwd)
        loss = -torch.log_softmax(logits.float(), -1)[..., 17].mean()
        grads = torch.autograd.grad(loss, [t for _, t in named])
        tx = make_optimizer(learning_rate=1e-3, total_steps=10)
        state = tx.init([t for _, t in named], [n for n, _ in named])
        with torch.no_grad():
            tx.apply(list(grads), state, [t for _, t in named])
        res["loss"] = float(loss)
        res["n_layers"] = len(model["layers"])
        res["moved"] = {n: float((t.detach() - b).abs().max())
                        for (n, t), b in zip(named, before)}
        res["n_leaves"] = len(named)
    return res


def _pipe_worker(rank, out_dir, np_path):
    from spacer_tpu_torch.parallel.mesh import create_mesh

    with open(np_path, "rb") as f:
        np_params = pickle.load(f)
    world = multihost.process_count()
    meshes, res = {}, {}
    for name, (w, shape, *_) in CASES.items():
        if w != world:
            continue
        key = tuple(sorted(shape.items()))
        if key not in meshes:
            meshes[key] = create_mesh(shape)
        res[name] = _run_case(name, np_params[CASES[name][2]], meshes[key])
    results = multihost.all_gather_objects(res)
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(results, f)


def _jax_refs(np_params):
    """JAX's results per case, from its pipeline where JAX's own test runs
    one, on meshes of the conftest's CPU devices."""
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import tiny_config
    from spacer_tpu.models.qwen25_vl.language import lm_forward
    from spacer_tpu.parallel.pipeline import (
        pipeline_lm_forward,
        shard_layers_for_pipeline,
    )
    from spacer_tpu.train import make_optimizer
    from spacer_tpu.train.step import make_grpo_train_step, make_sft_train_step

    def jcfg(layers):
        cfg = tiny_config()
        return dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_layers=layers))

    def jmesh(shape):
        names = tuple(shape)
        n = int(np.prod(list(shape.values())))
        return jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(tuple(shape.values())), names)

    refs = {}
    with jax.default_matmul_precision("highest"):
        for name, (_, shape, L, B, T, M) in CASES.items():
            cfg = jcfg(L)
            ids, mask, pos = (jnp.asarray(x) for x in
                              _data(B, T, vocab=cfg.text.vocab_size))
            mesh = jmesh(shape)
            full = jax.tree.map(jnp.asarray, np_params[L])
            model = shard_layers_for_pipeline(full["model"], mesh)
            fwd = dict(input_ids=ids, position_ids=pos, kv_mask=mask)
            if name in ("forward", "pipe_data", "single_stage_m_eq_b"):
                refs[name] = {
                    "pipe": np.asarray(pipeline_lm_forward(
                        model, cfg.text, mesh, num_microbatches=M,
                        batch_axis="data" if "data" in shape else None,
                        **fwd)),
                    "plain": np.asarray(lm_forward(model, cfg.text,
                                                   **fwd)[0])}
            elif name in ("grads", "update"):
                adv = jnp.asarray(_adv(B, 3))

                def loss_fn(p, name=name):
                    logits = lm_forward(p, cfg.text, **fwd)[0]
                    if name == "update":
                        return -jax.nn.log_softmax(
                            logits.astype(jnp.float32))[..., 17].mean()
                    lp = jax.nn.log_softmax(
                        logits[:, -7:-1].astype(jnp.float32))
                    tok = jnp.take_along_axis(lp, ids[:, -6:, None],
                                              axis=-1)[..., 0]
                    return -(adv[:, None] * tok).mean()

                loss, g = jax.value_and_grad(loss_fn)(full["model"])
                refs[name] = {"loss": float(loss),
                              "grads": jax.tree.map(np.asarray, g)}
            else:
                tx = make_optimizer(learning_rate=1e-3, total_steps=10,
                                    eps=1e-6)
                params = dict(full, model=model)
                if name == "grpo":
                    step = make_grpo_train_step(
                        cfg, tx, beta=0.04, remat=True, logp_chunk=8,
                        pipeline=(mesh, M))
                    batch = {"input_ids": ids, "kv_mask": mask,
                             "position_ids": pos,
                             "completion_mask": jnp.ones((B, C_GRPO),
                                                         jnp.int32),
                             "advantages": jnp.asarray(_adv(B, 7))}
                    p2, _, m = step(params, jax.tree.map(jnp.copy, params),
                                    tx.init(params), batch, grid_thw=None,
                                    num_generations=G_GRPO,
                                    prompt_len=P_GRPO)
                else:
                    step = make_sft_train_step(cfg, tx, logp_chunk=8,
                                               pipeline=(mesh, M))
                    batch = {"input_ids": ids, "kv_mask": mask,
                             "position_ids": pos,
                             "labels": jnp.where(mask, ids, -100)}
                    p2, _, m = step(params, tx.init(params), batch)
                refs[name] = {"metrics": {k: float(v) for k, v in m.items()},
                              "params": jax.tree.map(np.asarray, p2)}
    return refs


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import init_params, tiny_config

    root = tmp_path_factory.mktemp("pipe")
    np_params = {}
    for L in sorted({c[2] for c in CASES.values()}):
        cfg = tiny_config()
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_layers=L))
        np_params[L] = jax.tree.map(np.asarray, init_params(
            jax.random.key(0), cfg, jnp.float32))
    np_path = root / "params.pkl"
    with open(np_path, "wb") as f:
        pickle.dump(np_params, f)

    def launch(world):
        d = root / str(world)
        d.mkdir()
        multihost.launch_local(_pipe_worker, world,
                               args=(str(d), str(np_path)), device="cpu",
                               timeout=TIMEOUT, threads=1)
        with open(d / "result.pkl", "rb") as f:
            return pickle.load(f)

    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(launch, w) for w in (2, 4)}
        refs = _jax_refs(np_params)
        runs = {w: f.result() for w, f in futures.items()}
    return runs, refs, np_params


def _ranks(pipe_runs, name):
    runs, refs, np_params = pipe_runs
    return [r[name] for r in runs[CASES[name][0]]], refs[name], np_params


def _port_tree(np_tree, L, prefix=()):
    """JAX (stacked) tree -> {port param path: numpy}."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.train.step import param_leaves

    tree = params_from_jax(np_tree, _cfg(L))
    return {n: t.numpy() for n, t in param_leaves(tree)}


@pytest.mark.parametrize("name", ["forward", "single_stage_m_eq_b",
                                  "pipe_data"])
def test_pipeline_forward_matches_jax(pipe_runs, name):
    """test_pipeline_forward_matches_lm_forward (S = 4, M = 2),
    test_pipeline_single_stage_and_uneven_microbatches (S = 2, M = B) and
    test_pipeline_composes_with_data_parallel (pipe 2 x data 2): every
    stage's logits against JAX's pipeline and lm_forward."""
    ranks, ref, _ = _ranks(pipe_runs, name)
    assert len(ranks) == CASES[name][0]
    for r in ranks:
        np.testing.assert_allclose(r["logits"], ref["pipe"], atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(r["logits"], ref["plain"], atol=2e-5,
                                   rtol=2e-5)


def test_pipeline_train_step_grad_parity(pipe_runs):
    """The loss and every gradient (each stage's layers, the replicated
    tensors on every stage) against JAX's lm_forward gradients."""
    ranks, ref, _ = _ranks(pipe_runs, "grads")
    want = _port_tree({"model": ref["grads"]}, 4)
    seen = set()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g, want[n], atol=3e-5, rtol=3e-4,
                                       err_msg=n)
            seen.add(n)
    assert seen == set(want)


def _check_params(ranks, ref_params, L, atol):
    want = _port_tree(ref_params, L)
    seen = set()
    for r in ranks:
        for n, p in r["params"].items():
            np.testing.assert_allclose(p, want[n], atol=atol, err_msg=n)
            seen.add(n)
    assert seen == set(want)


def test_grpo_step_with_pipeline(pipe_runs):
    """make_grpo_train_step(pipeline=(mesh, 2)) on the packed schema: loss,
    kl and grad_norm against JAX's pipelined step, every updated tensor
    (each stage's layers, the replicated ones on every stage) within
    test_pipeline.py's 2e-4."""
    ranks, ref, _ = _ranks(pipe_runs, "grpo")
    for r in ranks:
        m = r["metrics"]
        np.testing.assert_allclose(m["loss"], ref["metrics"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["kl"], 0.0, atol=1e-6)
        np.testing.assert_allclose(m["grad_norm"],
                                   ref["metrics"]["grad_norm"], rtol=1e-4)
    _check_params(ranks, ref["params"], 4, 2e-4)
    stats = ranks[1]["stats"]
    assert stats["pp_send"]["calls"] and stats["pp_recv"]["calls"], stats


def test_sft_step_with_pipeline(pipe_runs):
    ranks, ref, _ = _ranks(pipe_runs, "sft")
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"],
                                   ref["metrics"]["loss"], rtol=1e-5)
    _check_params(ranks, ref["params"], 4, 2e-4)


def test_pipeline_composes_with_optimizer_update(pipe_runs):
    """One pipelined loss -> gradients -> AdamW update: the loss is JAX's,
    every stage holds its L / S layers only (its optimizer state too) and
    every one of them moved."""
    ranks, ref, _ = _ranks(pipe_runs, "update")
    L, S = 4, 4
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        assert np.isfinite(r["loss"])
        assert r["n_layers"] == L // S and r["span"] == [s]
        layer = {n: v for n, v in r["moved"].items()
                 if n.startswith("model/layers/")}
        assert layer and all(n.split("/")[2] == "0" for n in layer)
        assert all(v > 0 for n, v in layer.items() if n.endswith("kernel"))
    # the stages' leaves: each its own layer plus the replicated tensors
    assert len({r["n_leaves"] for r in ranks}) == 1


# -- one process ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    {"data": 1, "fsdp": 2, "tp": 2}, {"data": 2, "fsdp": 1, "tp": 4},
    {"data": 2, "fsdp": 2, "tp": 2}, {"fsdp": 8}])
def test_pipe_of_one_keeps_groups_and_coordinates(shape):
    n = int(np.prod(list(shape.values())))
    plain = _axis_groups(Mesh(shape, 0).shape)
    piped = _axis_groups(Mesh({**shape, "pipe": 1}, 0).shape)
    assert {k: v for k, v in piped.items() if k != "pipe"} == plain
    assert sorted(piped["pipe"]) == [[r] for r in range(n)]
    for r in range(n):
        a, b = Mesh(shape, r), Mesh({**shape, "pipe": 1}, r)
        assert b.coords == {"pipe": 0, **a.coords}
        assert b.batch_index == a.batch_index
        assert "pipe" not in a.shape and b.shape["pipe"] == 1


def test_pipe_major_coordinates_match_jax(cpu_devices):
    """Rank r sits where JAX's ("pipe", "data") test mesh puts device r."""
    devs = np.array(cpu_devices[:8]).reshape(4, 2)
    groups = _axis_groups(Mesh({"pipe": 4, "data": 2}, 0).shape)
    for p in range(4):
        for d in range(2):
            rank = cpu_devices.index(devs[p, d])
            assert Mesh({"pipe": 4, "data": 2}, rank).coords == {
                "pipe": p, "data": d, "fsdp": 0, "tp": 0}
    assert sorted(groups["pipe"]) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert sorted(groups["data"]) == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_single_stage_pipeline_is_lm_forward_bitwise():
    """S = 1, M = 1 on a mesh of one: logits and gradients bitwise those of
    lm_forward under the same remat."""
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.parallel.pipeline import pipeline_lm_forward
    from spacer_tpu_torch.train.step import param_leaves

    cfg = _cfg(2)
    model = init_params(cfg, seed=0)["model"]
    ids, mask, pos = (torch.from_numpy(x.copy()) for x in
                      _data(4, 16, vocab=cfg.text.vocab_size))
    leaves = [t for _, t in param_leaves(model)]
    for t in leaves:
        t.requires_grad_(True)
    kw = dict(input_ids=ids.long(), position_ids=pos.long(), kv_mask=mask)
    want = lm_forward(model, cfg.text, remat=True, **kw)[0]
    got = pipeline_lm_forward(model, cfg.text, Mesh({"pipe": 1}, 0),
                              num_microbatches=1, **kw)
    assert torch.equal(got, want)
    ga = torch.autograd.grad(want.square().mean(), leaves)
    gb = torch.autograd.grad(got.square().mean(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_refusals():
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.parallel.pipeline import (
        pipeline_lm_forward,
        shard_layers_for_pipeline,
    )
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    cfg = _cfg(3)
    model = init_params(cfg, seed=0)["model"]
    with pytest.raises(ValueError, match="not divisible into 2 stages"):
        shard_layers_for_pipeline(model, Mesh({"pipe": 2}, 0))
    ids = torch.zeros(3, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible into 2 microbatch"):
        pipeline_lm_forward(model, cfg.text, Mesh({"pipe": 1}, 0),
                            num_microbatches=2, input_ids=ids)
    for shape in ({"pipe": 2, "fsdp": 2}, {"pipe": 2, "tp": 2}):
        with pytest.raises(ValueError, match="composes with data only"):
            Mesh(shape, 0)
    # moe_impl "ep" is taken: a one-stage, one-microbatch pipeline of a
    # tiny Aria is its lm_forward bitwise (the worlds and M > 1 against JAX:
    # tests/test_torch_aria_pipeline_ring.py)
    from spacer_tpu_torch.models.aria import tiny_aria_config
    from spacer_tpu_torch.models.aria import init_params as aria_params
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward

    aria = dataclasses.replace(tiny_aria_config(), text=dataclasses.replace(
        tiny_aria_config().text, moe_impl="ep", moe_capacity_factor=0.5))
    amodel = aria_params(aria, seed=0)["model"]
    with torch.no_grad():
        got = pipeline_lm_forward(amodel, aria.text, Mesh({"pipe": 1}, 0),
                                  num_microbatches=1, input_ids=ids)
        assert torch.equal(got, lm_forward(amodel, aria.text, remat=True,
                                           input_ids=ids)[0])
    mesh = Mesh({"pipe": 1}, 0)
    full = init_params(cfg, seed=0)
    step = tstep.make_grpo_train_step(cfg, make_optimizer(),
                                      pipeline=(mesh, 1))
    shared = {"prompt_ids": torch.zeros(1, 4, dtype=torch.long),
              "prompt_mask": torch.ones(1, 4, dtype=torch.long),
              "prompt_position_ids": torch.zeros(3, 1, 4, dtype=torch.long),
              "completion_ids": torch.zeros(2, 2, dtype=torch.long),
              "completion_position_ids": torch.zeros(3, 2, 2,
                                                     dtype=torch.long),
              "completion_mask": torch.ones(2, 2, dtype=torch.long),
              "advantages": torch.zeros(2)}
    with pytest.raises(ValueError, match="packed"):
        step.ref_logps_fn(full, shared, num_generations=2)
    with pytest.raises(ValueError, match="mesh=None"):
        tstep.make_grpo_train_step(cfg, make_optimizer(), mesh=mesh,
                                   pipeline=(mesh, 1))
