"""Aria's capacity MoE (moe_impl "ep") under the pipeline and under ring
attention, against the JAX package on the CPU, float32.

The model is tiny_aria_config at capacity factor CF, low enough that both
packages drop assignments, with routers drawn wide (normal 0.5) so no
near-tie flips a top-k choice between them.  Each case asserts that
assignments were dropped and matches JAX; the pipelined cases also show
that their output differs from the unpipelined "ep" forward, so the tests
tell a microbatch's capacity from the whole batch's:

- the pipeline (JAX's stage body: every MoE call takes its capacity over
  this (pipe, data) rank's rows of one microbatch): pipe 1 with M = 2 in
  one process, and gloo worlds of pipe 2 and pipe 2 x data 2, against
  JAX's pipeline_lm_forward on ("pipe",) / ("pipe", "data") CPU meshes;
- the ring (self-attention sequence-parallel, its output all-gathered, so
  the MoE sees the whole batch: capacity over every token): world 1 in one
  process and gloo worlds of 2 and 4 over create_mesh({"fsdp": n}),
  against JAX's ring over the conftest's 8 CPU devices
  (tests/test_ring_lm_forward.py's pattern) and its plain forward;
- for each, the loss and every gradient of the packed GRPO step
  (make_grpo_train_step's loss_and_grads) against JAX's _completion_logps
  and grpo_loss through the same pipeline or ring (the JAX step's loss);
- in one process: an enclosing parallel/expert.rows layout changes
  nothing, and a recomputed layer (remat, the pipeline's backward) drops
  exactly what its forward dropped.

Tolerances: forward 2e-5 (tests/test_pipeline.py's); gradients 3e-5
absolute + 3e-4 relative and the loss 1e-5 relative
(tests/test_torch_pipeline.py's).  The workers import only torch, numpy
and spacer_tpu_torch (jax is imported inside the tests)."""

import dataclasses
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import multihost

TIMEOUT = 240
CF = 0.5
B, T, C, M = 4, 24, 8, 2
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=3e-5, rtol=3e-4)
# name -> (world, mesh shape): the gloo cases; "pipe1" and "ring1" run in
# this process
CASES = {"pipe2": (2, {"pipe": 2}), "ring2": (2, {"fsdp": 2}),
         "pipe2_data2": (4, {"pipe": 2, "data": 2}), "ring4": (4, {"fsdp": 4})}
PIPE_CASES = ("pipe1", "pipe2", "pipe2_data2")
RING_CASES = ("ring1", "ring2", "ring4")


def _cfg():
    from spacer_tpu_torch.models.aria import tiny_aria_config

    cfg = tiny_aria_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, moe_impl="ep", moe_capacity_factor=CF))


def _inputs(vocab):
    """ids (B, T) with one left-padded row, its mask and positions, and the
    packed GRPO rows' completion mask (the last C tokens, one row ending
    early) and advantages."""
    rng = np.random.default_rng(0)
    ids = rng.integers(10, vocab, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[0, :3] = False
    cmask = np.ones((B, C), np.int32)
    cmask[1, 5:] = 0
    mask[:, T - C:] &= cmask.astype(bool)
    pos = np.broadcast_to(np.maximum(np.cumsum(mask, 1) - 1, 0)[None],
                          (3, B, T)).astype(np.int32)
    adv = rng.normal(size=(B,)).astype(np.float32)
    return {"input_ids": ids, "kv_mask": mask, "position_ids": pos,
            "completion_mask": cmask, "advantages": adv}


def _torch_batch(np_batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(x))
           for k, x in np_batch.items()}
    for key in ("input_ids", "position_ids"):
        out[key] = out[key].long()
    return out


class _Drops:
    """Each MoE call's keep mask (ops/moe.kept_expert_ffn's `keep`)."""

    def __enter__(self):
        import spacer_tpu_torch.ops.moe as moe

        self.moe, self.saved, self.keeps = moe, moe.kept_expert_ffn, []

        def counted(fc1, fc2, xt, code, keep, *a):
            self.keeps.append(keep.detach().clone())
            return self.saved(fc1, fc2, xt, code, keep, *a)

        moe.kept_expert_ffn = counted
        return self

    def __exit__(self, *exc):
        self.moe.kept_expert_ffn = self.saved
        return False

    def dropped(self) -> list:
        return [int((~k).sum()) for k in self.keeps]


def _case_run(name, mesh, np_params):
    """One case on this rank: the forward's logits and each MoE call's
    drops, then the packed GRPO loss and gradients ({path: numpy}, a
    stage's layers under their global indices)."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.parallel.pipeline import (
        pipeline_lm_forward,
        shard_layers_for_pipeline,
        stage_layers,
    )
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    cfg = _cfg()
    batch = _torch_batch(_inputs(cfg.text.vocab_size))
    pipe = name.startswith("pipe")
    batch_axis = "data" if "data" in mesh.shape and pipe else None
    span = (list(stage_layers(cfg.text.num_layers, mesh)) if pipe
            else list(range(cfg.text.num_layers)))

    def params():
        p = params_from_jax(np_params, cfg)
        if pipe:
            p["model"] = shard_layers_for_pipeline(p["model"], mesh)
        return p

    fwd = dict(input_ids=batch["input_ids"],
               position_ids=batch["position_ids"], kv_mask=batch["kv_mask"])
    model = params()["model"]
    with torch.no_grad(), _Drops() as drops:
        if pipe:
            logits = pipeline_lm_forward(model, cfg.text, mesh,
                                         num_microbatches=M,
                                         batch_axis=batch_axis, **fwd)
        else:
            logits = lm_forward(model, cfg.text, remat=True,
                                attn_impl=("ring", mesh, "fsdp"), **fwd)[0]
    kw = ({"pipeline": (mesh, M)} if pipe
          else {"attn_impl": ("ring", mesh, "fsdp")})
    step = tstep.make_grpo_train_step(cfg, make_optimizer(), beta=0.04,
                                      remat=True, logp_chunk=8, **kw)
    p = params()
    ref_logps = step.ref_logps_fn(p, batch, num_generations=B)
    loss, _, grads = step.loss_and_grads(p, ref_logps, batch,
                                         num_generations=B)
    out = {}
    for (n, _), g in zip(tstep.param_leaves(p), grads):
        parts = n.split("/")
        if parts[0] != "model":
            continue
        if parts[:2] == ["model", "layers"]:
            parts[2] = str(span[int(parts[2])])
        out["/".join(parts)] = g.numpy()
    return {"logits": logits.numpy(), "drops": drops.dropped(),
            "loss": float(loss), "grads": out}


def _worker(rank, out_dir, np_path):
    from spacer_tpu_torch.parallel.mesh import create_mesh

    with open(np_path, "rb") as f:
        np_params = pickle.load(f)
    world = multihost.process_count()
    res = {name: _case_run(name, create_mesh(shape), np_params)
           for name, (w, shape) in CASES.items() if w == world}
    results = multihost.all_gather_objects(res)
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(results, f)


def _np_params():
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models import aria as jaria

    cfg = _cfg()
    np_params = jax.tree.map(np.asarray, jaria.init_params(
        jax.random.key(0), cfg, jnp.float32))
    r = np_params["model"]["layers"]["mlp"]["router"]
    r["kernel"] = np.random.default_rng(1).normal(
        0, 0.5, r["kernel"].shape).astype(np.float32)
    return np_params


def _jax_refs(np_params):
    """JAX's logits and packed GRPO loss and gradients: plain, through its
    pipeline on ("pipe",) meshes of 1 and 2 devices and a ("pipe", "data")
    mesh of 2 x 2, and through its ring over 8 devices."""
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl.language import lm_forward
    from spacer_tpu.parallel.pipeline import (
        pipeline_lm_forward,
        shard_layers_for_pipeline,
    )
    from spacer_tpu.train.grpo import grpo_loss
    from spacer_tpu.train.step import _completion_logps

    cfg = _cfg()
    batch = {k: jnp.asarray(x) for k, x in _inputs(
        cfg.text.vocab_size).items()}
    fwd = dict(input_ids=batch["input_ids"],
               position_ids=batch["position_ids"], kv_mask=batch["kv_mask"])
    full = jax.tree.map(jnp.asarray, np_params)

    def mesh(shape):
        n = int(np.prod(list(shape.values())))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(
            tuple(shape.values())), tuple(shape))

    def loss_and_grads(params, **kw):
        def logps(p):
            return _completion_logps(
                p, cfg, batch["input_ids"], batch["position_ids"],
                batch["kv_mask"], T - C, remat=True, logp_chunk=8, **kw)

        ref = jax.lax.stop_gradient(logps(params))

        def loss_fn(p):
            return grpo_loss(logps(p), ref, batch["advantages"],
                             batch["completion_mask"], beta=0.04)[0]

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
        return float(loss), jax.tree.map(np.asarray, g["model"])

    refs = {}
    with jax.default_matmul_precision("highest"):
        refs["plain"] = {
            "logits": np.asarray(lm_forward(full["model"], cfg.text,
                                            **fwd)[0])}
        for name, shape in (("pipe1", {"pipe": 1}), ("pipe2", {"pipe": 2}),
                            ("pipe2_data2", {"pipe": 2, "data": 2})):
            m = mesh(shape)
            params = dict(full, model=shard_layers_for_pipeline(
                full["model"], m))
            batch_axis = "data" if "data" in shape else None
            logits = np.asarray(pipeline_lm_forward(
                params["model"], cfg.text, m, num_microbatches=M,
                batch_axis=batch_axis, **fwd))
            loss, g = loss_and_grads(params, pipeline=(m, M))
            refs[name] = {"logits": logits, "loss": loss, "grads": g}
        impl = ("ring", mesh({"fsdp": 8}), "fsdp")
        logits = np.asarray(jax.jit(lambda p: lm_forward(
            p["model"], cfg.text, attn_impl=impl, **fwd)[0])(full))
        loss, g = loss_and_grads(full, attn_impl=impl)
        refs["ring"] = {"logits": logits, "loss": loss, "grads": g}
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: [each rank's result]} (the gloo worlds and this process's
    pipe 1 / ring 1), JAX's references, the params."""
    from spacer_tpu_torch.parallel.mesh import Mesh

    root = tmp_path_factory.mktemp("aria_pp_ring")
    np_params = _np_params()
    np_path = root / "params.pkl"
    with open(np_path, "wb") as f:
        pickle.dump(np_params, f)

    def launch(world):
        d = root / str(world)
        d.mkdir()
        multihost.launch_local(_worker, world, args=(str(d), str(np_path)),
                               device="cpu", timeout=TIMEOUT, threads=1)
        with open(d / "result.pkl", "rb") as f:
            return pickle.load(f)

    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(launch, w) for w in (2, 4)}
        refs = _jax_refs(np_params)
        results = {"pipe1": [_case_run("pipe1", Mesh({"pipe": 1}, 0),
                                       np_params)],
                   "ring1": [_case_run("ring1", Mesh({"fsdp": 1}, 0),
                                       np_params)]}
        for f in futures.values():
            ranks = f.result()
            results.update({name: [r[name] for r in ranks]
                            for name in ranks[0]})
    return results, refs, np_params


def _ref(refs, name):
    return refs["ring"] if name.startswith("ring") else refs[name]


def _port_grads(np_grads):
    """JAX's gradient tree of the LM -> {port param path: numpy}."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.train.step import param_leaves

    return {n: t.numpy() for n, t in param_leaves(
        params_from_jax({"model": np_grads}, _cfg()))}


@pytest.mark.parametrize("name", PIPE_CASES + RING_CASES)
def test_ep_forward_matches_jax(runs, name):
    """Every rank's logits against JAX's pipeline / ring, with assignments
    dropped; a pipelined forward differs from the unpipelined one (its
    capacity is a microbatch's), the ring's equals it (the whole batch's)."""
    results, refs, _ = runs
    ref = _ref(refs, name)
    assert len(results[name]) == (CASES[name][0] if name in CASES else 1)
    for r in results[name]:
        assert sum(r["drops"]) > 0, r["drops"]
        np.testing.assert_allclose(r["logits"], ref["logits"], **FWD)
        if name.startswith("pipe"):
            assert np.abs(r["logits"] - refs["plain"]["logits"]).max() > 1e-2
        else:
            np.testing.assert_allclose(r["logits"], refs["plain"]["logits"],
                                       **FWD)
    if name.startswith("ring"):
        # every rank's MoE ran the whole batch: one process's drops
        plain = results["ring1"][0]["drops"]
        assert all(r["drops"] == plain for r in results[name])


@pytest.mark.parametrize("name", PIPE_CASES + RING_CASES)
def test_ep_grpo_loss_and_grads_match_jax(runs, name):
    """The packed GRPO step's loss and every gradient (a stage's layers, the
    replicated tensors on every rank) against JAX's through the same
    pipeline or ring."""
    results, refs, _ = runs
    ref = _ref(refs, name)
    want = _port_grads(ref["grads"])
    seen = set()
    for r in results[name]:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g, want[n], err_msg=n, **GRAD)
            seen.add(n)
    assert seen == set(want)


def _one_process(kind, np_params, remat=False, grad=False):
    """A pipe-1 (M = 2) or ring-1 forward in this process -> (logits, the
    params' leaves)."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.parallel.mesh import Mesh
    from spacer_tpu_torch.parallel.pipeline import pipeline_lm_forward
    from spacer_tpu_torch.train.step import param_leaves

    cfg = _cfg()
    batch = _torch_batch(_inputs(cfg.text.vocab_size))
    model = params_from_jax(np_params, cfg)["model"]
    leaves = [t for _, t in param_leaves(model)]
    for t in leaves:
        t.requires_grad_(grad)
    fwd = dict(input_ids=batch["input_ids"],
               position_ids=batch["position_ids"], kv_mask=batch["kv_mask"])
    if kind == "pipe":
        return pipeline_lm_forward(model, cfg.text, Mesh({"pipe": 1}, 0),
                                   num_microbatches=M, remat=remat,
                                   **fwd), leaves
    return lm_forward(model, cfg.text, remat=remat,
                      attn_impl=("ring", Mesh({"fsdp": 1}, 0), "fsdp"),
                      **fwd)[0], leaves


@pytest.mark.parametrize("kind", ["pipe", "ring"])
def test_ep_ignores_an_enclosing_row_layout(runs, kind):
    """A parallel/expert.rows layout set by an enclosing caller (rows split
    over two batch ranks) reaches no stage's or ring's MoE call: the output
    and the drops are bitwise those without one."""
    from spacer_tpu_torch.parallel import expert

    np_params = runs[2]
    with torch.no_grad():
        with _Drops() as a:
            want = _one_process(kind, np_params)[0]
        with expert.rows(expert.RowLayout(2 * B, ((0, B), (B, 2 * B)))), \
                _Drops() as b:
            got = _one_process(kind, np_params)[0]
    assert torch.equal(got, want)
    assert sum(a.dropped()) > 0
    assert len(a.keeps) == len(b.keeps)
    assert all(torch.equal(x, y) for x, y in zip(a.keeps, b.keeps))


@pytest.mark.parametrize("kind", ["pipe", "ring"])
def test_recomputed_moe_drops_what_its_forward_dropped(runs, kind):
    """Under remat every MoE call of the backward (the pipeline's backward
    walks the ticks in reverse) recomputes one of the forward's calls and
    keeps exactly the assignments that call kept."""
    np_params = runs[2]
    with _Drops() as drops:
        out, leaves = _one_process(kind, np_params, remat=True, grad=True)
        n_fwd = len(drops.keeps)
        torch.autograd.grad(out.square().mean(), leaves)
    cfg = _cfg()
    calls = cfg.text.num_layers * (M if kind == "pipe" else 1)
    assert n_fwd == calls and len(drops.keeps) == 2 * calls
    fwd, bwd = drops.keeps[:n_fwd], drops.keeps[n_fwd:]
    assert sum(int((~k).sum()) for k in fwd) > 0
    key = lambda k: k.numpy().tobytes()  # noqa: E731
    assert sorted(map(key, fwd)) == sorted(map(key, bwd))
