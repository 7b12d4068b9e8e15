"""Tensor parallelism end to end on the CPU: gloo process groups of 2 and
4 spawned processes (parallel.multihost.launch_local, each run limited to
TIMEOUT seconds) against the single-process port (run the same way) and
the JAX package, at the tiny config in float32.

The tiny config has 4 LM heads, 2 KV heads and 2 ViT heads, so tp 4 runs
`_wide`: 4 KV heads and 4 ViT heads, on both packages.

- `lm_forward` logits (left-padded rows) and `vit_forward` embeddings of
  both ViTs at tp 2 and 4 against the JAX functions on the same numpy
  params (1e-4, tests/test_torch_language.py's tolerance).
- `QwenEngine.generate_many` (bf16 and int4_kv decode; video and text
  requests through 2 slots) and `Sampler.generate` greedy: token for token
  as world 1.
- The GRPO step, two updates, over (data 1, fsdp 1, tp 2), (1, 2, 2) and
  (2, 1, 2) against world 1 and JAX's step on a (1, 1, 2) device mesh,
  under tests/test_torch_fsdp_trainer.py's gates (loss, kl and grad_norm
  1e-5 relative of world 1 and 1e-4 of JAX; params `_close_params`; int8
  moments `_close_moments`).
- One SFT step at tp 2 against world 1.
- A checkpoint saved at tp 2 (params and int8 moments) restores at world 1
  bitwise, and at tp 2 into the same slices bitwise.

The workers import only torch, numpy and spacer_tpu_torch (jax is imported
inside the tests)."""

import dataclasses
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import fsdp, multihost

TIMEOUT = 150
TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = {"tp2": {"data": 1, "fsdp": 1, "tp": 2},
          "fsdp2_tp2": {"data": 1, "fsdp": 2, "tp": 2},
          "data2_tp2": {"data": 2, "fsdp": 1, "tp": 2},
          "tp4": {"data": 1, "fsdp": 1, "tp": 4}}


def _wide(cfg):
    """A tiny config tp 4 divides: 4 KV heads, 4 ViT heads."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_kv_heads=4),
        vision=dataclasses.replace(cfg.vision, num_heads=4))


def _cfg(wide: bool, arch: str = "qwen2_5"):
    from spacer_tpu_torch.models.qwen25_vl import tiny_config

    cfg = tiny_config(arch=arch)
    return _wide(cfg) if wide else cfg


def _prompts(cfg):
    rng = np.random.default_rng(3)
    ids = rng.integers(10, cfg.text.vocab_size, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, :6] = 0
    ids[1, :6] = cfg.pad_token_id
    return ids, mask


def _pixels(grids, cfg, seed):
    S = sum(t * h * w for t, h, w in grids)
    return np.random.default_rng(seed).normal(
        size=(S, cfg.vision.patch_dim)).astype(np.float32)


GRIDS = ((2, 8, 12), (2, 8, 8))


def _messages():
    from PIL import Image

    rng = np.random.default_rng(0)

    def frames(n, size):
        return [Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                             np.uint8)) for _ in range(n)]

    def user(*content):
        return [{"role": "user", "content": list(content)}]

    return [user({"type": "video", "video": frames(4, 112)},
                 {"type": "text", "text": "what is on the table"}),
            user({"type": "text", "text": "count the chairs in the room"}),
            user({"type": "video", "video": frames(2, 56)},
                 {"type": "text", "text": "and here"})]


# -- the spawned ranks ---------------------------------------------------------


def _place(params, cfg, mesh):
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        qwen_tp_plan,
        shard_params,
    )

    if mesh is None:
        return params
    return shard_params(params, mesh, QWEN_PARTITION_RULES,
                        qwen_tp_plan(cfg))[0]


def _forward(np_params, cfg, np_vit2, cfg2, mesh):
    """LM logits and the embeddings of both ViTs."""
    from spacer_tpu_torch.models.qwen25_vl import get_rope_index
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.models.qwen25_vl.vision import (
        vision_layout,
        vit_forward,
    )

    params = fsdp.gather_params(_place(params_from_jax(np_params, cfg), cfg,
                                       mesh))
    ids, mask = _prompts(cfg)
    pos, _ = get_rope_index(cfg, ids, attention_mask=mask)
    with torch.no_grad():
        logits, _ = lm_forward(params["model"], cfg.text,
                               input_ids=torch.from_numpy(ids),
                               position_ids=torch.from_numpy(pos),
                               kv_mask=torch.from_numpy(mask).bool())
        ve = vit_forward(params["visual"], cfg.vision,
                         torch.from_numpy(_pixels(GRIDS, cfg, 0)),
                         vision_layout(GRIDS, cfg.vision))
        p2 = fsdp.gather_params(_place(params_from_jax(np_vit2, cfg2), cfg2,
                                       mesh))
        ve2 = vit_forward(p2["visual"], cfg2.vision,
                          torch.from_numpy(_pixels(GRIDS, cfg2, 1)),
                          vision_layout(GRIDS, cfg2.vision))
    return logits.numpy(), ve.numpy(), ve2.numpy()


def _serve(np_params, cfg, mesh):
    """generate_many token ids (bf16 and int4_kv decode) and a greedy
    Sampler.generate over a video prompt."""
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.evalharness.engine import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.serving import ContinuousBatcher

    params = fsdp.gather_params(_place(params_from_jax(np_params, cfg), cfg,
                                       mesh))
    proc = VLProcessor(MockTokenizer(cfg.text.vocab_size), cfg)
    out = {}
    for quant in (None, "int4_kv"):
        engine = QwenEngine(cfg, params, proc, length_bucket=64,
                            decode_quant=quant)
        reqs = [engine.encode_request(m) for m in _messages()]
        Pmax = max(r["input_ids"].shape[1] for r in reqs)
        outs = ContinuousBatcher(
            cfg, params, slots=2, prompt_len=-(-Pmax // 64) * 64,
            max_new_tokens=12, temperature=0.0, chunk_steps=4,
            eos_token_id=proc.eos_token_id, pad_token_id=proc.pad_token_id,
            decode_quant=quant).run(reqs)
        out[quant] = [o.sequences[:o.length].copy() for o in outs]
        out[f"texts_{quant}"] = engine.generate_many(
            _messages(), max_new_tokens=8, temperature=0.0, slots=2,
            chunk_steps=3)
    engine = QwenEngine(cfg, params, proc, length_bucket=64)
    out["static"] = engine.generate(_messages(), max_new_tokens=8,
                                    temperature=0.0)
    return out


def _grpo(np_params, cfg, mesh, ckpt=None):
    """Two GRPO updates on tests/test_torch_fsdp_trainer.py's batch ->
    (metrics, full params, full int8 moments); with `ckpt`, the state is
    saved there, restored into fresh slices and checked bitwise."""
    import test_torch_fsdp_trainer as ft

    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from spacer_tpu_torch.train.optimizer import make_optimizer

    params = _place(params_from_jax(np_params, cfg), cfg, mesh)
    ref = _place(params_from_jax(np_params, cfg), cfg, mesh)
    tx = make_optimizer(**ft.STEP_OPT, sr_impl="off")
    leaves = tstep.param_leaves(params)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves],
                    blocks=fsdp.shard_blocks(params))
    step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                      logp_chunk=8, mesh=mesh)
    batch = ft._torch_batch(ft._step_batch(cfg))
    metrics = []
    for _ in range(2):
        params, state, m = step(params, ref, state, batch,
                                grid_thw=ft.STEP_GRID * ft.STEP_B,
                                num_generations=ft.G)
        metrics.append({k: float(m[k]) for k in ("loss", "kl", "grad_norm")})
    if ckpt is not None:
        save_train_state(ckpt, params, state, {"global_step": 2})
        like = _place(params_from_jax(np_params, cfg), cfg, mesh)
        got, got_state, _ = restore_train_state(
            ckpt, like, tx.init([t for _, t in tstep.param_leaves(like)],
                                [n for n, _ in tstep.param_leaves(like)],
                                blocks=fsdp.shard_blocks(like)))
        for (_, a), (_, b) in zip(tstep.param_leaves(got),
                                  tstep.param_leaves(params)):
            assert torch.equal(a, b)
        for a, b in zip(got_state.mu + got_state.nu, state.mu + state.nu):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    return _full(params, state, metrics)


def _full(params, state, metrics):
    from spacer_tpu_torch.train.step import param_leaves

    if fsdp.has_shards(params):
        state = fsdp.state_to_full(state, params)
        params = fsdp.full_params(params)
    return (metrics, [t.detach().numpy().copy()
                      for _, t in param_leaves(params)],
            [tuple(x.numpy().copy() for x in pair)
             for pair in state.mu + state.nu])


def _sft(cfg, mesh, out):
    import test_torch_fsdp_trainer as ft

    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.train.sft_trainer import SFTConfig, SFTTrainer

    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)
    args = SFTConfig(learning_rate=ft.LR, max_steps=1,
                     per_device_batch_size=2, num_train_epochs=1,
                     output_dir=out, seq_bucket=64, logp_chunk=8,
                     moment_dtype="float32")
    trainer = SFTTrainer(cfg, _place(init_params(cfg, seed=0), cfg, mesh),
                         proc, ft._sft_rows(), args, mesh=mesh)
    batch, grid = trainer.collate(trainer.dataset)
    trainer.params, trainer.opt_state, m = trainer.step_fn(
        trainer.params, trainer.opt_state, batch, grid_thw=grid)
    return float(m["loss"]), fsdp.full_params(trainer.params)


def _worker(rank, key, out_dir, np_path):
    from spacer_tpu_torch.parallel.mesh import create_mesh

    with open(np_path, "rb") as f:
        np_params = pickle.load(f)
    world = multihost.process_count()
    wide = key in ("tp4", "w1_wide")
    mesh = create_mesh(SHAPES[key]) if key in SHAPES else None
    cfg, cfg2 = _cfg(wide), _cfg(wide, "qwen2")
    np_main = np_params["wide" if wide else "std"]
    np_vit2 = np_params["qwen2_wide" if wide else "qwen2"]
    res = {}
    if key in ("w1", "w1_wide", "tp2", "tp4"):
        res["forward"] = _forward(np_main, cfg, np_vit2, cfg2, mesh)
        res["serve"] = _serve(np_main, cfg, mesh)
    if key in ("w1", "tp2", "fsdp2_tp2", "data2_tp2"):
        ckpt = os.path.join(out_dir, "ckpt") if key == "tp2" else None
        res["grpo"] = _grpo(np_main, cfg, mesh, ckpt)
        if key in ("w1", "tp2"):
            res["sft"] = _sft(cfg, mesh, os.path.join(out_dir, "sft"))
        if mesh is not None:
            res["tp_calls"] = {k: v["calls"] for k, v in
                               multihost.collective_stats().items()
                               if k.startswith("tp_")}
    assert world == (1 if mesh is None else mesh.size)
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(res, f)


# -- the tests -----------------------------------------------------------------


def _jax_params():
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import init_params as jax_init
    from spacer_tpu.models.qwen25_vl import tiny_config as jax_tiny

    out = {}
    for name, arch, wide in (("std", "qwen2_5", False), ("wide", "qwen2_5", True),
                             ("qwen2", "qwen2", False),
                             ("qwen2_wide", "qwen2", True)):
        cfg = jax_tiny(arch=arch)
        cfg = _wide(cfg) if wide else cfg
        # key 0: tests/test_torch_fsdp_trainer.py's params, whose GRPO
        # step it holds to the same gates
        out[name] = jax.tree.map(np.asarray, jax_init(
            jax.random.key(0), cfg, jnp.float32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    np_params = _jax_params()
    np_path = root / "np_params.pkl"
    with open(np_path, "wb") as f:
        pickle.dump(np_params, f)
    out = {"np_params": np_params, "root": root}
    # every rank (and the world-1 references, run the same way) hashes the
    # mock tokenizer's words alike
    hashseed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"

    def launch(key):
        d = root / key
        d.mkdir()
        world = (int(np.prod(list(SHAPES[key].values())))
                 if key in SHAPES else 1)
        multihost.launch_local(_worker, world,
                               args=(key, str(d), str(np_path)),
                               device="cpu", timeout=TIMEOUT, threads=1)
        with open(d / "result.pkl", "rb") as f:
            return pickle.load(f)

    keys = ("w1", "w1_wide", "tp2", "tp4", "fsdp2_tp2", "data2_tp2")
    try:
        # the worlds are independent process groups: run them side by side
        with ThreadPoolExecutor(len(keys)) as pool:
            out.update(zip(keys, pool.map(launch, keys)))
    finally:
        if hashseed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = hashseed
    return out


@pytest.mark.parametrize("key", ["tp2", "tp4"])
def test_forward_and_both_vits_match_jax(runs, key):
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import get_rope_index as jax_rope
    from spacer_tpu.models.qwen25_vl import tiny_config as jax_tiny
    from spacer_tpu.models.qwen25_vl.language import lm_forward as jax_lm
    from spacer_tpu.models.qwen25_vl.vision import (
        vision_layout as jax_layout,
    )
    from spacer_tpu.models.qwen25_vl.vision import vit_forward as jax_vit

    wide = key == "tp4"
    cfg, cfg2 = jax_tiny(), jax_tiny(arch="qwen2")
    if wide:
        cfg, cfg2 = _wide(cfg), _wide(cfg2)
    p = runs["np_params"]["wide" if wide else "std"]
    p2 = runs["np_params"]["qwen2_wide" if wide else "qwen2"]
    ids, mask = _prompts(cfg)
    pos, _ = jax_rope(cfg, ids, attention_mask=mask)
    jlogits, _ = jax_lm(p["model"], cfg.text, input_ids=jnp.asarray(ids),
                        position_ids=jnp.asarray(pos),
                        kv_mask=jnp.asarray(mask, bool))
    jve = jax_vit(p["visual"], cfg.vision, jnp.asarray(_pixels(GRIDS, cfg, 0)),
                  jax_layout(GRIDS, cfg.vision), attn_impl="xla")
    jve2 = jax_vit(p2["visual"], cfg2.vision,
                   jnp.asarray(_pixels(GRIDS, cfg2, 1)),
                   jax_layout(GRIDS, cfg2.vision), attn_impl="xla")
    logits, ve, ve2 = runs[key]["forward"]
    ref = runs["w1_wide" if wide else "w1"]["forward"]
    live = mask.astype(bool)
    np.testing.assert_allclose(logits[live], np.asarray(jlogits)[live], **TOL)
    np.testing.assert_allclose(ve, np.asarray(jve), **TOL)
    np.testing.assert_allclose(ve2, np.asarray(jve2), **TOL)
    # and world 1 of the port, to summation order
    for a, b in zip((logits, ve, ve2), ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["tp2", "tp4"])
def test_served_tokens_equal_world_one(runs, key):
    got = runs[key]["serve"]
    ref = runs["w1_wide" if key == "tp4" else "w1"]["serve"]
    for quant in (None, "int4_kv"):
        assert len(got[quant]) == len(ref[quant]) == 3
        for a, b in zip(got[quant], ref[quant]):
            np.testing.assert_array_equal(a, b)
        assert got[f"texts_{quant}"] == ref[f"texts_{quant}"]
    assert got["static"] == ref["static"]


@pytest.fixture(scope="module")
def jax_tp_steps(runs):
    """JAX's GRPO step, two updates, on a (data 1, fsdp 1, tp 2) device
    mesh (GSPMD) -> (metrics, params in the port's param_leaves order)."""
    import jax
    import jax.numpy as jnp

    import test_torch_fsdp_trainer as ft
    from spacer_tpu.models.qwen25_vl import tiny_config as jax_tiny
    from spacer_tpu.parallel.mesh import create_mesh as jax_mesh
    from spacer_tpu.parallel.partition import shard_params as jax_shard
    from spacer_tpu.train.optimizer import make_optimizer as jax_make_opt
    from spacer_tpu.train.step import make_grpo_train_step as jax_make_step
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.models.qwen25_vl import tiny_config
    from spacer_tpu_torch.train.step import param_leaves

    os.environ["SPACER_ADAM8_SR"] = "off"
    try:
        cfg = jax_tiny()
        mesh = jax_mesh({"data": 1, "fsdp": 1, "tp": 2},
                        devices=jax.devices()[:2])
        np_params = runs["np_params"]["std"]
        jtx = jax_make_opt(**ft.STEP_OPT)
        jparams, _ = jax_shard(jax.tree.map(jnp.asarray, np_params), mesh)
        jref, _ = jax_shard(jax.tree.map(jnp.asarray, np_params), mesh)
        jstate = jtx.init(jparams)
        jstep = jax_make_step(cfg, jtx, beta=0.04, remat=True, logp_chunk=8)
        jb = {k: jnp.asarray(v) for k, v in ft._step_batch(cfg).items()}
        metrics = []
        for _ in range(2):
            with jax.default_matmul_precision("highest"):
                jparams, jstate, jm = jstep(
                    jparams, jref, jstate, jb,
                    grid_thw=ft.STEP_GRID * ft.STEP_B,
                    num_generations=ft.G, prompt_len=ft.STEP_P,
                    grids_per_prompt=(1,) * ft.STEP_B)
            metrics.append({k: float(jm[k]) for k in ("loss", "kl",
                                                      "grad_norm")})
    finally:
        del os.environ["SPACER_ADAM8_SR"]
    return metrics, [t.numpy() for _, t in param_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams), tiny_config()))]


@pytest.mark.parametrize("key", ["tp2", "fsdp2_tp2", "data2_tp2"])
def test_grpo_step_matches_world_one_and_jax(runs, jax_tp_steps, key):
    import test_torch_fsdp_trainer as ft

    m1, p1, mu1 = runs["w1"]["grpo"]
    mw, pw, muw = runs[key]["grpo"]
    for a, b in zip(mw, m1):
        for k in ("loss", "kl", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    ft._close_params(pw, p1)
    ft._close_moments(muw, mu1)
    jm, jleaves = jax_tp_steps
    for a, b in zip(mw, jm):
        for k in ("loss", "kl", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-7), k
    for i, (a, b) in enumerate(zip(pw, jleaves)):
        diff = np.abs(a - b)
        assert (diff > 5e-6).sum() <= max(2, diff.size // 1000), i
        assert diff.max() <= 2e-4, i
    # two all-reduces per layer and step at least, counted under tp kinds
    assert runs[key]["tp_calls"]["tp_all_reduce"] > 0
    assert runs[key]["tp_calls"]["tp_all_gather"] > 0


def test_sft_step_matches_world_one(runs):
    import test_torch_fsdp_trainer as ft
    from spacer_tpu_torch.train.step import param_leaves

    l1, p1 = runs["w1"]["sft"]
    l2, p2 = runs["tp2"]["sft"]
    assert l2 == pytest.approx(l1, rel=1e-5)
    # the key biases' gradient is all summation noise (a softmax row's
    # shift), which float32 Adam turns into steps of up to a learning
    # rate: `_close_params` holds them to that bound by name
    names = [n for n, _ in param_leaves(p1)]
    ft._close_params([t.detach().numpy() for _, t in param_leaves(p2)],
                     [t.detach().numpy() for _, t in param_leaves(p1)], names)


def test_checkpoint_saved_at_tp2_restores_at_world_one(runs):
    """Saved at tp 2 (full tensors and world-1 moments), restored at world
    1: every param and int8 moment bitwise as the tp-2 run had them (and
    at tp 2 into the same slices, checked inside the run)."""
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.train.checkpoint import restore_train_state
    from spacer_tpu_torch.train.optimizer import make_optimizer
    from spacer_tpu_torch.train.step import param_leaves

    import test_torch_fsdp_trainer as ft

    like = init_params(tiny_config(), seed=1)
    leaves = param_leaves(like)
    tx = make_optimizer(**ft.STEP_OPT, sr_impl="off")
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    params, state, meta = restore_train_state(
        str(runs["root"] / "tp2" / "ckpt"), like, state)
    _, p2, mu2 = runs["tp2"]["grpo"]
    assert meta["global_step"] == 2
    for (_, a), b in zip(param_leaves(params), p2):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for pair, ref in zip(state.mu + state.nu, mu2):
        for a, b in zip(pair, ref):
            np.testing.assert_array_equal(a.numpy(), b)
