"""The Aria family over (data, fsdp, tp) meshes on the CPU: gloo process
groups spawned by parallel.multihost.launch_local (one group per world
size running its meshes one after another, each run limited to TIMEOUT
seconds, the worlds side by side) against the single-process port
(run the same way) and the JAX package, tiny_aria_config in float32,
under moe_impl "ragged" and "ep" (the experts placed by expert over fsdp,
over data or over data x fsdp: moe_ep_axis, parallel/expert.py).

The tiny tower has 2 heads, so tp 4 runs `_wide` (4 tower heads) on both
packages.  Routers are drawn wide (normal 0.5) so no near-tie flips a
top-k choice.

- `lm_forward` logits (left-padded rows) and the tower + projector's
  embeddings at tp 2 and 4, both impls, against JAX (1e-4) and world 1.
- `QwenEngine.generate_many` (text through the batcher) and a greedy
  `Sampler.generate` of an image prompt and of two text prompts (G = 2)
  at tp 2 (ragged), ep 2 (fsdp 2) and ep over data 2: token for token as
  world 1.  At ep 2
  the Sampler splits the text prompts over the ranks and one rank's rows
  hit EOS at their first step while the other's decode on: the ranks must
  leave the loop together (a rank that left early would hang the other at
  its next expert exchange, which the run's timeout turns into a failure).
- The GRPO step, two updates of int8-moment AdamW on a text batch of 2
  prompts x G = 4 (so at data 2 x fsdp 2 two ranks hold each prompt row),
  over (1, 1, 2) ragged and (1, 2, 1), (1, 2, 2), (2, 2, 1) ep over fsdp,
  (2, 1, 1) ep over data and (2, 2, 1) ep over data x fsdp, against world
  1 and JAX's step on a device mesh ((1, 1, 2) ragged, (1, 2, 1) ep,
  (2, 1, 1) ep with moe_ep_axis "data"), under
  tests/test_torch_fsdp_trainer.py's gates, but that one
  element of a tensor may differ from JAX by `_close_params`'s two
  learning rates: JAX's own ep step on a mesh moves one element of a
  shared expert's gate_proj, whose step-2 gradient sits at the summation
  noise, 0.88 learning rates away from JAX's single-device step (which
  the port's world 1 equals to 2e-8 there).  Expert-parallel collectives
  counted.
- Checkpoints saved at (1, 2, 2) ep and at (2, 2, 1) ep over data x fsdp
  restore at world 1 bitwise.

The workers import only torch, numpy and spacer_tpu_torch (jax is
imported inside the tests)."""

import dataclasses
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import fsdp, multihost

TIMEOUT = 300
TOL = dict(atol=1e-4, rtol=1e-4)
G = 4
B, P, C = 2, 24, 8
SHAPES = {"tp2": {"tp": 2}, "tp4": {"tp": 4}, "ep2": {"fsdp": 2},
          "ep2_tp2": {"fsdp": 2, "tp": 2}, "d2_ep2": {"data": 2, "fsdp": 2},
          "ep_data2": {"data": 2}, "ep_batch4": {"data": 2, "fsdp": 2}}
# the ep axis of a key's config (moe_ep_axis; fsdp elsewhere)
EP_AXIS = {"ep_data2": "data", "ep_batch4": ("data", "fsdp")}
PROC_KW = dict(max_image_size=56, min_image_size=14, size_conversion={56: 8})


def _cfg(impl: str, wide: bool = False, ep_axis="fsdp"):
    from spacer_tpu_torch.models.aria import tiny_aria_config

    cfg = tiny_aria_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, moe_impl=impl, moe_ep_axis=ep_axis))
    if wide:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, num_heads=4))
    return cfg


def _place(params, cfg, mesh):
    from spacer_tpu_torch.parallel.partition import (
        ARIA_PARTITION_RULES,
        aria_tp_plan,
        shard_params,
    )

    if mesh is None:
        return params
    return shard_params(params, mesh, ARIA_PARTITION_RULES,
                        aria_tp_plan(cfg))[0]


def _params(np_params, cfg, mesh):
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax

    return _place(params_from_jax(np_params, cfg), cfg, mesh)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    ids = rng.integers(10, cfg.text.vocab_size, (B, 20))
    mask = np.ones((B, 20), np.int64)
    mask[1, :6] = 0
    ids[1, :6] = cfg.pad_token_id
    return ids, mask


def _image(cfg):
    from spacer_tpu_torch.models.aria import vision_position_ids

    v = cfg.vision
    side = v.image_size // v.patch_size
    px = np.random.default_rng(4).uniform(
        -1, 1, (2, v.image_size, v.image_size, 3)).astype(np.float32)
    mask = np.zeros((2, side, side), bool)
    mask[0], mask[1, :3] = True, True
    pos = np.stack([vision_position_ids(side, side, v),
                    vision_position_ids(3, side, v, side, side)])
    return px, pos, mask.reshape(2, -1)


# -- the spawned ranks ---------------------------------------------------------


def _forward(np_params, cfg, mesh):
    from spacer_tpu_torch.models.aria import encode_vision, lm_forward
    from spacer_tpu_torch.models.registry import aria_positions
    from spacer_tpu_torch.parallel import expert

    params = fsdp.gather_params(_params(np_params, cfg, mesh))
    ids, mask = _prompts(cfg)
    pos, _ = aria_positions(cfg, ids, mask)
    px, ppos, pmask = _image(cfg)
    with torch.no_grad(), expert.rows(expert.EVERY_RANK):
        logits, _ = lm_forward(params["model"], cfg.text,
                               input_ids=torch.from_numpy(ids),
                               position_ids=torch.from_numpy(pos),
                               kv_mask=torch.from_numpy(mask).bool())
        ve = encode_vision(params, cfg, torch.from_numpy(px),
                           torch.from_numpy(ppos),
                           patch_mask=torch.from_numpy(pmask))
    return logits.numpy(), ve.numpy()


def _serve(np_params, cfg, mesh):
    """generate_many token ids and greedy Sampler tokens (an image prompt,
    and two text prompts whose first row ends at its first step)."""
    from spacer_tpu_torch.data.aria_processor import (
        AriaProcessor,
        MockAriaTokenizer,
    )
    from spacer_tpu_torch.evalharness.engine import QwenEngine
    from spacer_tpu_torch.models.registry import aria_positions, get_family
    from spacer_tpu_torch.sampler import Sampler

    params = fsdp.gather_params(_params(np_params, cfg, mesh))
    tok = MockAriaTokenizer(cfg.text.vocab_size)
    out = {}
    msgs = [[{"role": "user", "content": "count the chairs in the room"}],
            [{"role": "user", "content": "x y"}],
            [{"role": "user", "content": "what is on the table today"}]]
    out["texts"] = QwenEngine(cfg, params, AriaProcessor(tok, cfg),
                              length_bucket=32).generate_many(
        msgs, max_new_tokens=7, temperature=0.0, slots=2, chunk_steps=3)
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3), np.uint8)
    enc = AriaProcessor(tok, cfg, **PROC_KW).process_messages([[{
        "role": "user", "content": [{"type": "image", "image": img},
                                    {"type": "text", "text": "what is it"}]}]])
    vk, _ = get_family("aria").pack_vision(enc)
    pos, deltas = aria_positions(cfg, enc["input_ids"], enc["attention_mask"])
    out["image"] = Sampler(cfg, length_bucket=16, mesh=mesh).generate(
        enc["input_ids"], enc["attention_mask"], params, position_ids=pos,
        deltas=deltas, vision_kwargs=vk, num_generations=1,
        max_new_tokens=6, temperature=0.0).sequences
    ids, mask = _prompts(cfg)
    pos, deltas = aria_positions(cfg, ids, mask)
    kw = dict(position_ids=pos, deltas=deltas, num_generations=2,
              max_new_tokens=20, temperature=0.0)
    # EOS is the first row's first token: its completions end at once (the
    # same batch: under "ep" the capacity depends on it)
    first = Sampler(cfg, length_bucket=32).generate(
        ids, mask, params, **dict(kw, max_new_tokens=1)).sequences[0, 0]
    out["eos"] = int(first)
    out["text"] = Sampler(cfg, eos_token_id=int(first), length_bucket=32,
                          mesh=mesh).generate(ids, mask, params, **kw)
    return out


def _step_batch(cfg):
    """B text prompts (left-padded) x G fixed completions, shared-prefix."""
    from spacer_tpu_torch.models.registry import aria_positions

    rng = np.random.default_rng(0)
    ids = rng.integers(10, cfg.text.vocab_size, (B, P))
    mask = np.ones((B, P), np.int64)
    ids[1, :5], mask[1, :5] = cfg.pad_token_id, 0
    pos, deltas = aria_positions(cfg, ids, mask)
    N = B * G
    comp_mask = np.ones((N, C), np.int32)
    comp_mask[:, C - 3:] = rng.integers(0, 2, size=(N, 3))
    comp_pos = np.repeat(deltas.reshape(-1, 1) + P + np.arange(C)[None], G, 0)
    return {
        "prompt_ids": ids.astype(np.int32),
        "prompt_mask": mask.astype(np.int32),
        "prompt_position_ids": pos.astype(np.int32),
        "completion_ids": rng.integers(10, cfg.text.vocab_size,
                                       (N, C)).astype(np.int32),
        "completion_position_ids": np.broadcast_to(
            comp_pos[None], (3, N, C)).astype(np.int32),
        "completion_mask": comp_mask,
        "advantages": rng.normal(size=(N,)).astype(np.float32),
    }


def _grpo(np_params, cfg, mesh, ckpt=None):
    """Two GRPO updates -> (metrics, full params, full int8 moments, the
    expert-parallel collectives' calls); with `ckpt` the state is saved
    there."""
    import test_torch_fsdp_trainer as ft

    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.checkpoint import save_train_state
    from spacer_tpu_torch.train.optimizer import make_optimizer

    multihost.reset_collective_stats()
    params = _params(np_params, cfg, mesh)
    ref = _params(np_params, cfg, mesh)
    tx = make_optimizer(**ft.STEP_OPT, sr_impl="off")
    leaves = tstep.param_leaves(params)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves],
                    blocks=fsdp.shard_blocks(params))
    step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                      logp_chunk=8, mesh=mesh)
    batch = ft._torch_batch(_step_batch(cfg))
    metrics = []
    for _ in range(2):
        params, state, m = step(params, ref, state, batch,
                                num_generations=G)
        metrics.append({k: float(m[k]) for k in ("loss", "kl", "grad_norm")})
    calls = {k: v["calls"] for k, v in multihost.collective_stats().items()
             if k.startswith("ep_")}
    if ckpt is not None:
        save_train_state(ckpt, params, state, {"global_step": 2})
    return (*_full(params, state, metrics), calls)


def _full(params, state, metrics):
    from spacer_tpu_torch.train.step import param_leaves

    if fsdp.has_shards(params):
        state = fsdp.state_to_full(state, params)
        params = fsdp.full_params(params)
    return (metrics, [t.detach().numpy().copy()
                      for _, t in param_leaves(params)],
            [tuple(x.numpy().copy() for x in pair)
             for pair in state.mu + state.nu])


def _run_key(key, np_params, out_dir):
    from spacer_tpu_torch.parallel import tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    wide = key in ("tp4", "w1_wide")
    mesh = create_mesh(SHAPES[key]) if key in SHAPES else None
    np_main = np_params["wide" if wide else "std"]
    res = {}
    if key in ("w1", "w1_wide", "tp2", "tp4"):
        res["forward"] = {impl: _forward(np_main, _cfg(impl, wide), mesh)
                          for impl in ("ragged", "ep")}
    if key in ("w1", "tp2"):
        res["serve_ragged"] = _serve(np_main, _cfg("ragged"), mesh)
    ep_cfg = _cfg("ep", ep_axis=EP_AXIS.get(key, "fsdp"))
    if key in ("w1", "ep2", "ep_data2"):
        res["serve_ep"] = _serve(np_main, ep_cfg, mesh)
    if key in ("w1", "tp2"):
        res["grpo_ragged"] = _grpo(np_main, _cfg("ragged"), mesh)
    if key in ("w1", "ep2", "ep2_tp2", "d2_ep2", "ep_data2", "ep_batch4"):
        ckpt = (os.path.join(out_dir, "ckpt")
                if key in ("ep2_tp2", "ep_batch4") else None)
        res["grpo_ep"] = _grpo(np_main, ep_cfg, mesh, ckpt)
    tp.set_mesh(None)     # the next key's mesh (or none) is its own
    return res


def _worker(rank, keys, out_dir, np_path):
    """The keys of one world size, one after another in one process
    group (each key its own mesh)."""
    with open(np_path, "rb") as f:
        np_params = pickle.load(f)
    res = {}
    for key in keys:
        d = os.path.join(out_dir, key)
        os.makedirs(d, exist_ok=True)
        res[key] = _run_key(key, np_params, d)
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(res, f)


# -- the tests -----------------------------------------------------------------


def _jax_params():
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models import aria as jaria

    out = {}
    for name, wide in (("std", False), ("wide", True)):
        cfg = _jax_cfg("ragged", wide)
        p = jax.tree.map(np.asarray, jaria.init_params(
            jax.random.key(7), cfg, jnp.float32))
        r = p["model"]["layers"]["mlp"]["router"]
        r["kernel"] = np.random.default_rng(3).normal(
            0, 0.5, r["kernel"].shape).astype(np.float32)
        out[name] = p
    return out


def _jax_cfg(impl, wide=False, ep_axis="fsdp"):
    from spacer_tpu.models.aria import tiny_aria_config as jax_tiny

    cfg = jax_tiny()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, moe_impl=impl, moe_ep_axis=ep_axis))
    if wide:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, num_heads=4))
    return cfg


def _jax_steps(np_params):
    """JAX's GRPO step, two updates, per impl: ragged on a (1, 1, 2), ep on
    a (1, 2, 1) device mesh and, as "ep_data", ep with moe_ep_axis "data"
    on a (2, 1, 1) one -> {impl: (metrics, params in the port's
    param_leaves order)}."""
    import jax
    import jax.numpy as jnp

    import test_torch_fsdp_trainer as ft
    from spacer_tpu.parallel.mesh import create_mesh as jax_mesh
    from spacer_tpu.parallel.partition import ARIA_PARTITION_RULES
    from spacer_tpu.parallel.partition import place_batch as jax_place
    from spacer_tpu.parallel.partition import shard_params as jax_shard
    from spacer_tpu.train.optimizer import make_optimizer as jax_make_opt
    from spacer_tpu.train.step import make_grpo_train_step as jax_make_step
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.train.step import param_leaves

    out = {}
    os.environ["SPACER_ADAM8_SR"] = "off"
    try:
        for name, impl, shape, axis in (
                ("ragged", "ragged", {"data": 1, "fsdp": 1, "tp": 2}, "fsdp"),
                ("ep", "ep", {"data": 1, "fsdp": 2, "tp": 1}, "fsdp"),
                ("ep_data", "ep", {"data": 2, "fsdp": 1, "tp": 1}, "data")):
            cfg = _jax_cfg(impl, ep_axis=axis)
            mesh = jax_mesh(shape, devices=jax.devices()[:2])
            jtx = jax_make_opt(**ft.STEP_OPT)
            jparams, _ = jax_shard(jax.tree.map(jnp.asarray, np_params), mesh,
                                   ARIA_PARTITION_RULES)
            jref, _ = jax_shard(jax.tree.map(jnp.asarray, np_params), mesh,
                                ARIA_PARTITION_RULES)
            jstate = jtx.init(jparams)
            jstep = jax_make_step(cfg, jtx, beta=0.04, remat=True,
                                  logp_chunk=8)
            jb = {k: jnp.asarray(v) for k, v in _step_batch(
                _cfg(impl)).items()}
            metrics = []
            for _ in range(2):
                with jax.default_matmul_precision("highest"), \
                        jax.sharding.set_mesh(mesh):
                    jparams, jstate, jm = jstep(
                        jparams, jref, jstate, jax_place(jb, mesh),
                        grid_thw=None, num_generations=G, prompt_len=P)
                metrics.append({k: float(jm[k]) for k in ("loss", "kl",
                                                          "grad_norm")})
            out[name] = (metrics, [t.numpy() for _, t in param_leaves(
                params_from_jax(jax.tree.map(np.asarray, jparams),
                                _cfg(impl)))])
    finally:
        del os.environ["SPACER_ADAM8_SR"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("aria_tp")
    np_params = _jax_params()
    np_path = root / "np_params.pkl"
    with open(np_path, "wb") as f:
        pickle.dump(np_params, f)
    out = {"np_params": np_params, "root": root}
    # every rank (and the world-1 references, run the same way) hashes the
    # mock tokenizer's words alike
    hashseed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"

    def launch(world, keys):
        d = root / f"world{world}"
        d.mkdir()
        multihost.launch_local(_worker, world,
                               args=(keys, str(d), str(np_path)),
                               device="cpu", timeout=TIMEOUT, threads=1)
        with open(d / "result.pkl", "rb") as f:
            return pickle.load(f)

    # one process group per world size, its keys one after another
    worlds = {1: ("w1", "w1_wide"), 2: ("tp2", "ep2", "ep_data2"),
              4: ("tp4", "ep2_tp2", "d2_ep2", "ep_batch4")}
    try:
        # the worlds run side by side, and JAX's reference steps meanwhile
        with ThreadPoolExecutor(len(worlds)) as pool:
            futures = [pool.submit(launch, w, k) for w, k in worlds.items()]
            out["jax"] = _jax_steps(np_params["std"])
            for f in futures:
                out.update(f.result())
    finally:
        if hashseed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = hashseed
    return out


@pytest.mark.parametrize("key", ["tp2", "tp4"])
@pytest.mark.parametrize("impl", ["ragged", "ep"])
def test_forward_and_tower_match_jax(runs, key, impl):
    import jax.numpy as jnp

    from spacer_tpu.models import aria as jaria
    from spacer_tpu_torch.models.registry import aria_positions

    wide = key == "tp4"
    cfg = _jax_cfg(impl, wide)
    p = jax_tree(runs["np_params"]["wide" if wide else "std"])
    ids, mask = _prompts(cfg)
    pos, _ = aria_positions(cfg, ids, mask)
    jlogits, _ = jaria.lm_forward(p["model"], cfg.text,
                                  input_ids=jnp.asarray(ids),
                                  position_ids=jnp.asarray(pos),
                                  kv_mask=jnp.asarray(mask, bool))
    px, ppos, pmask = _image(cfg)
    jve = jaria.encode_vision(p, cfg, jnp.asarray(px), jnp.asarray(ppos),
                              patch_mask=jnp.asarray(pmask))
    logits, ve = runs[key]["forward"][impl]
    live = mask.astype(bool)
    np.testing.assert_allclose(logits[live], np.asarray(jlogits)[live], **TOL)
    np.testing.assert_allclose(ve, np.asarray(jve), **TOL)
    ref = runs["w1_wide" if wide else "w1"]["forward"][impl]
    for a, b in zip((logits, ve), ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def jax_tree(np_params):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, np_params)


@pytest.mark.parametrize("key,impl", [("tp2", "ragged"), ("ep2", "ep"),
                                      ("ep_data2", "ep")])
def test_generate_equals_world_one(runs, key, impl):
    got, ref = runs[key][f"serve_{impl}"], runs["w1"][f"serve_{impl}"]
    assert got["texts"] == ref["texts"] and all(got["texts"])
    np.testing.assert_array_equal(got["image"], ref["image"])
    np.testing.assert_array_equal(got["text"].sequences,
                                  ref["text"].sequences)
    np.testing.assert_array_equal(got["text"].lengths, ref["text"].lengths)
    # the lockstep: the first prompt's rows ended at once, the second's ran
    # on past the first done check
    lengths = ref["text"].lengths
    assert (lengths[:2] == 1).all() and (lengths[2:] > 9).any(), lengths


def _close_to_jax(mw, pw, jm, jleaves):
    """tests/test_torch_fsdp_trainer.py's JAX gates (metrics 1e-4
    relative, params 5e-6 but for 1e-3 of a tensor's elements, those
    within 2e-4), except that one element of a tensor may take
    `_close_params`'s two learning rates: see the module docstring."""
    import test_torch_fsdp_trainer as ft

    for a, b in zip(mw, jm):
        for k in ("loss", "kl", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-7), k
    for i, (a, b) in enumerate(zip(pw, jleaves)):
        diff = np.abs(a - b)
        assert (diff > 5e-6).sum() <= max(2, diff.size // 1000), i
        assert (diff > 2e-4).sum() <= 1, i
        assert diff.max() <= 2 * ft.LR + 1e-6, i


@pytest.mark.parametrize("key,impl", [("tp2", "ragged"), ("ep2", "ep"),
                                      ("ep2_tp2", "ep"), ("d2_ep2", "ep"),
                                      ("ep_data2", "ep"), ("ep_batch4", "ep")])
def test_grpo_step_matches_world_one_and_jax(runs, key, impl):
    """Two GRPO updates against world 1 and JAX's step: the experts placed
    over fsdp, over data ((2, 1, 1): against JAX's step with moe_ep_axis
    "data" on a (2, 1, 1) device mesh) and over data x fsdp ((2, 2, 1): a
    JAX ep step, whose values the axis does not change)."""
    import test_torch_fsdp_trainer as ft

    m1, p1, mu1, _ = runs["w1"][f"grpo_{impl}"]
    mw, pw, muw, calls = runs[key][f"grpo_{impl}"]
    for a, b in zip(mw, m1):
        for k in ("loss", "kl", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    ft._close_params(pw, p1)
    ft._close_moments(muw, mu1)
    _close_to_jax(mw, pw, *runs["jax"]["ep_data" if key == "ep_data2"
                                       else impl])
    if impl == "ep":
        # rows split within the ep group: gathered in, scattered out
        assert calls["ep_all_gather"] > 0 and calls["ep_reduce_scatter"] > 0
        assert calls["ep_counts"] > 0


def test_checkpoint_saved_at_ep_tp_restores_at_world_one(runs):
    """Saved at (1, 2, 2) ep: every param and int8 moment restores at world
    1 bitwise as the sharded run had them."""
    _restores_at_world_one(runs, "ep2_tp2")


def test_checkpoint_saved_at_ep_over_data_fsdp_restores_at_world_one(runs):
    """Saved at (2, 2, 1) with the experts placed over data x fsdp: every
    param and int8 moment restores at world 1 bitwise."""
    _restores_at_world_one(runs, "ep_batch4")


def _restores_at_world_one(runs, key):
    import test_torch_fsdp_trainer as ft

    from spacer_tpu_torch.models.aria import init_params
    from spacer_tpu_torch.train.checkpoint import restore_train_state
    from spacer_tpu_torch.train.optimizer import make_optimizer
    from spacer_tpu_torch.train.step import param_leaves

    like = init_params(_cfg("ep"), seed=1)
    leaves = param_leaves(like)
    tx = make_optimizer(**ft.STEP_OPT, sr_impl="off")
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    params, state, meta = restore_train_state(
        str(runs["root"] / "world4" / key / "ckpt"), like, state)
    _, p2, mu2, _ = runs[key]["grpo_ep"]
    assert meta["global_step"] == 2
    for (_, a), b in zip(param_leaves(params), p2):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for pair, ref in zip(state.mu + state.nu, mu2):
        for a, b in zip(pair, ref):
            np.testing.assert_array_equal(a.numpy(), b)


# -- cli/serve.py under torch.distributed.run -----------------------------------


def _serve_cli(tmp, world, impl, mesh_flag):
    """cli.serve on a jsonl of text rows at the tiny random Aria (float32,
    greedy): one process, or `world` ranks under torch.distributed.run
    with `mesh_flag` ("--tp" or "--fsdp" = world); moe_impl from
    SPACER_MOE_IMPL, as the config reads it.  -> the output rows."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    inp = tmp / "in.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in (
        {"prompt": "what is on the table"}, {"prompt": "count the chairs"},
        {"messages": [{"role": "user", "content": "hi there"}]})))
    out = tmp / f"out_{world}_{impl}.jsonl"
    argv = ["--model_family", "aria", "--random_init", "true", "--dtype",
            "float32", "--device", "cpu", "--input_file", str(inp),
            "--output_file", str(out), "--max_new_tokens", "6",
            "--temperature", "0", "--slots", "2"]
    cmd = [sys.executable, "-m", "spacer_tpu_torch.cli.serve", *argv]
    if world > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(world), "--standalone",
               "-m", "spacer_tpu_torch.cli.serve",
               "--multihost", "true", mesh_flag, str(world), *argv]
    env = dict(os.environ, PYTHONPATH=repo, PYTHONHASHSEED="0",
               OMP_NUM_THREADS="1", SPACER_MOE_IMPL=impl)
    res = subprocess.run(cmd, cwd=str(tmp), env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("impl,mesh_flag", [("ragged", "--tp"),
                                            ("ep", "--tp"), ("ep", "--fsdp")])
def test_serve_cli_aria_under_torchrun(tmp_path, impl, mesh_flag):
    """`cli/serve.py --model_family aria --multihost true` over 2 ranks
    (tp 2, or fsdp 2 with the experts placed by expert under "ep") writes
    the one-process run's completions."""
    one = _serve_cli(tmp_path, 1, impl, mesh_flag)
    two = _serve_cli(tmp_path, 2, impl, mesh_flag)
    assert len(one) == 3 and all(r["completion"] for r in one)
    assert [r["completion"] for r in two] == [r["completion"] for r in one]
