"""Training over fsdp-sharded params on the CPU: gloo process groups of 2
and 4 spawned processes (parallel.multihost.launch_local, each run limited
to TIMEOUT seconds) against the single-process port and the JAX package,
at the tiny config in float32.

- The GRPO step (`make_grpo_train_step`, 3 prompts x G = 4, so the ranks'
  completion rows cut across prompt groups) two updates at world 2 and 4:
  the same losses as world 1 (rtol 1e-5) and as JAX's single-device step
  (tests/test_torch_train_step.py's tolerances: loss, kl and grad_norm
  1e-4 relative; params 5e-6 absolute, int8 moments with deterministic
  rounding allowing 1e-3 of a tensor's elements one code apart, each within
  2e-4).
- `SGRLVRTrainer.training_step` twice over 4 video rows, handed to the
  ranks unequally (3 + 1 at world 2; 2 + 1 + 1 + 0 at world 4, with the
  optimizer state offloaded to host memory between updates), at
  temperature 1 with the temporal shuffle and int8 moments with
  stochastic rounding: the completions token for token and the rewards
  exactly as world 1 (each row gets the draws it gets in one process), the
  losses within 1e-5, the params and int8 moments gathered back within the
  summation-order tolerance stated at `_close_params` / `_close_moments`.
- SFT two steps and an Aria GRPO step at world 2 against world 1.
- A checkpoint saved at world 2 restores at world 1 and at world 4 (into
  an offloaded state) with every param and moment bitwise.
- The grouped rollout at temperature 1 over fsdp 2, fsdp 4 and (data 2,
  fsdp 2), token for token as world 1; the GRPO step also over (data 2,
  fsdp 2).  The speculative rollout (k = 2, greedy and at temperature 1)
  over the same meshes: tokens and acceptance counts exactly world 1's,
  its greedy tokens JAX's speculative sampler's.
- `python -m torch.distributed.run --nproc_per_node 2 -m
  spacer_tpu_torch.cli.train_sg_rlvr --multihost true --device cpu` takes
  a step.

The spawned workers import only torch, numpy and spacer_tpu_torch (jax is
imported inside the tests)."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import fsdp, multihost

TIMEOUT = 120
G = 4
STEP_GRID = ((2, 8, 8),)
STEP_P, STEP_C, STEP_B = 48, 12, 3
ROW_SPLITS = {1: (0, 4), 2: (0, 3, 4), 4: (0, 2, 3, 4, 4)}
LR = 1e-3


# -- shared by the workers and the tests ---------------------------------------


def length_reward(completions, **kwargs):
    return [float(len(c[0]["content"]) % 5) for c in completions]


def parity_reward(completions, **kwargs):
    return [0.5 * (i % 2) for i in range(len(completions))]


def _video_rows(n=4):
    from spacer_tpu_torch.data import make_conversation

    rows = []
    for i in range(n):
        frames = np.random.default_rng(i).integers(0, 256, (4, 56, 84, 3),
                                                   np.uint8)
        row = {"problem": f"How many chairs are visible? ({i})",
               "problem_type": "numerical", "solution": "<answer>3</answer>",
               "path": frames, "data_type": "video",
               "data_source": "synthetic", "problem_id": i}
        row.update(make_conversation(row))
        rows.append(row)
    return rows


def _sg_trainer(params, out, mesh=None, **over):
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import tiny_config
    from spacer_tpu_torch.rewards import format_reward
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    cfg = tiny_config()
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)
    args = SGRLVRConfig(
        num_generations=G, max_prompt_length=512, max_completion_length=6,
        learning_rate=LR, max_steps=2, logging_steps=1, save_steps=100,
        prompt_bucket=64, logp_chunk=8, decode_quant=None,
        moment_dtype="int8", output_dir=str(out), seed=3, **over)
    trainer = SGRLVRTrainer(cfg, params, proc,
                            [length_reward, format_reward, parity_reward],
                            [], args, mesh=mesh)
    rollouts = []
    generate = trainer.sampler.generate

    def recording(*a, **kw):
        res = generate(*a, **kw)
        rollouts.append(np.asarray(res.sequences))
        return res

    trainer.sampler.generate = recording
    return trainer, rollouts


def _step_batch(cfg):
    """STEP_B prompts (each with a video grid) x G fixed completions."""
    from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

    rng = np.random.default_rng(0)
    n_video = (2 * 8 * 8) // 4
    ids, masks = [], []
    for b in range(STEP_B):
        prompt = ([10 + b, 11, cfg.vision_start_token_id]
                  + [cfg.video_token_id] * n_video
                  + [cfg.vision_end_token_id, 20, 21 + b][:3 - (b % 2)])
        pad = STEP_P - len(prompt)
        ids.append([cfg.pad_token_id] * pad + prompt)
        masks.append([0] * pad + [1] * len(prompt))
    prompt_ids, prompt_mask = np.array(ids), np.array(masks)
    grids = np.array(STEP_GRID * STEP_B)
    pos, deltas = get_rope_index(cfg, prompt_ids, video_grid_thw=grids,
                                 attention_mask=prompt_mask)
    N = STEP_B * G
    completion = rng.integers(10, cfg.text.vocab_size, size=(N, STEP_C))
    comp_mask = np.ones((N, STEP_C), np.int32)
    comp_mask[:, STEP_C - 3:] = rng.integers(0, 2, size=(N, 3))
    comp_pos = np.repeat(deltas.reshape(-1, 1) + STEP_P
                         + np.arange(STEP_C)[None], G, 0)
    return {
        "prompt_ids": prompt_ids.astype(np.int32),
        "prompt_mask": prompt_mask.astype(np.int32),
        "prompt_position_ids": pos.astype(np.int32),
        "completion_ids": completion.astype(np.int32),
        "completion_position_ids": np.broadcast_to(
            comp_pos[None], (3, N, STEP_C)).astype(np.int32),
        "completion_mask": comp_mask,
        "advantages": rng.normal(size=(N,)).astype(np.float32),
        "pixel_values": rng.normal(size=(STEP_B * 2 * 8 * 8,
                                         cfg.vision.patch_dim)
                                   ).astype(np.float32),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    for k in ("prompt_ids", "prompt_mask", "prompt_position_ids",
              "completion_ids", "completion_position_ids", "completion_mask"):
        out[k] = out[k].long()
    return out


STEP_OPT = dict(learning_rate=LR, total_steps=10, warmup_steps=1,
                moment_dtype="int8", max_grad_norm=0.5, weight_decay=0.0,
                eps=1e-6)


def _run_grpo_step(np_params, mesh):
    """Two GRPO updates on the fixed batch -> (metrics, full params, full
    int8 moments) as numpy."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax, tiny_config
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        shard_params,
    )
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    cfg = tiny_config()
    params = params_from_jax(np_params, cfg)
    ref = params_from_jax(np_params, cfg)
    if mesh is not None:
        params, _ = shard_params(params, mesh, QWEN_PARTITION_RULES)
        ref, _ = shard_params(ref, mesh, QWEN_PARTITION_RULES)
    tx = make_optimizer(**STEP_OPT, sr_impl="off")
    leaves = tstep.param_leaves(params)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves],
                    blocks=fsdp.shard_blocks(params))
    step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                      logp_chunk=8, mesh=mesh)
    batch = _torch_batch(_step_batch(cfg))
    metrics = []
    for _ in range(2):
        params, state, m = step(params, ref, state, batch,
                                grid_thw=STEP_GRID * STEP_B,
                                num_generations=G)
        metrics.append({k: float(m[k]) for k in ("loss", "kl", "grad_norm")})
    return metrics, *_full(params, state)


def _full(params, state):
    """Gathered params and world-1 optimizer state as numpy lists."""
    from spacer_tpu_torch.train.step import param_leaves

    if fsdp.has_shards(params):
        state = fsdp.state_to_full(state, params)
        params = fsdp.gather_params(params)
    inner = getattr(state, "inner_opt_state", state)
    return ([t.detach().numpy().copy() for _, t in param_leaves(params)],
            [tuple(x.numpy().copy() for x in pair)
             for pair in inner.mu + inner.nu])


def _run_rollout(mesh):
    """A temperature-1 grouped rollout of 2 prompts x G over the tiny
    params (sharded onto `mesh` if given) -> sequences."""
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        shard_params,
    )
    from spacer_tpu_torch.sampler import Sampler

    cfg = tiny_config()
    params = init_params(cfg, seed=0)
    if mesh is not None:
        params = shard_params(params, mesh, QWEN_PARTITION_RULES)[0]
    rng = np.random.default_rng(7)
    ids = rng.integers(10, 900, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, :5] = 0
    pos = np.broadcast_to(np.clip(np.cumsum(mask, 1) - 1, 0, None)[None],
                          (3, 2, 20)).copy()
    deltas = (pos[0].max(1, keepdims=True) + 1 - 20).astype(np.int64)
    out = Sampler(cfg, length_bucket=32, mesh=mesh).generate(
        ids, mask, params, position_ids=pos, deltas=deltas,
        num_generations=G, max_new_tokens=8, temperature=1.0, seed=11)
    return out.sequences


def _spec_prompts(vocab):
    """2 prompts with repeated bigrams to draft from, one left-padded."""
    r = np.random.RandomState(5)
    ids = r.randint(10, vocab, size=(2, 12)).astype(np.int32)
    ids[:, 6:] = ids[:, :6]
    mask = np.ones((2, 12), np.int32)
    mask[1, :2] = 0
    pos = np.broadcast_to(np.arange(12)[None, None], (3, 2, 12)).astype(
        np.int32)
    return ids, mask, pos, np.zeros((2, 1), np.int32)


SPEC_KW = dict(num_generations=2, max_new_tokens=24, top_p=0.95, seed=3)


def _run_spec_rollout(np_params, mesh):
    """Speculative (k = 2) grouped rollouts of the JAX-initialised tiny
    params, greedy and at temperature 1 -> {temperature: (sequences,
    stats)}."""
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax, tiny_config
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        shard_params,
    )
    from spacer_tpu_torch.sampler import Sampler

    cfg = tiny_config()
    params = params_from_jax(np_params, cfg)
    if mesh is not None:
        params = shard_params(params, mesh, QWEN_PARTITION_RULES)[0]
    ids, mask, pos, deltas = _spec_prompts(cfg.text.vocab_size)
    sampler = Sampler(cfg, eos_token_id=11, pad_token_id=0, length_bucket=8,
                      speculate_k=2, mesh=mesh)
    out = {}
    for temp in (0.0, 1.0):
        res = sampler.generate(ids, mask, params, position_ids=pos,
                               deltas=deltas, temperature=temp, **SPEC_KW)
        out[temp] = (res.sequences, res.stats)
    return out


def _sft_rows():
    return [{"problem": f"What is shown? ({i})", "problem_type": "free-form",
             "solution": "<answer>a room</answer>",
             "path": np.random.default_rng(10 + i).integers(
                 0, 256, (4, 56, 84, 3), np.uint8),
             "data_type": "video"} for i in range(2)]


def _run_sft(params, out, mesh):
    from spacer_tpu_torch.data import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl import tiny_config
    from spacer_tpu_torch.train.sft_trainer import SFTConfig, SFTTrainer

    cfg = tiny_config()
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)
    args = SFTConfig(learning_rate=LR, max_steps=2, per_device_batch_size=2,
                     num_train_epochs=2, output_dir=str(out), seq_bucket=64,
                     logp_chunk=8, moment_dtype="float32")
    trainer = SFTTrainer(cfg, params, proc, _sft_rows(), args, mesh=mesh)
    losses = []
    for _ in range(2):
        batch, grid = trainer.collate(trainer.dataset)
        trainer.params, trainer.opt_state, m = trainer.step_fn(
            trainer.params, trainer.opt_state, batch, grid_thw=grid)
        losses.append(float(m["loss"]))
    return losses, *_full(trainer.params, trainer.opt_state)


def _aria_setup(out):
    from PIL import Image

    path = os.path.join(out, "scene.png")
    if not os.path.exists(path):
        Image.fromarray(np.random.default_rng(0).integers(
            0, 255, (120, 160, 3), np.uint8)).save(path)
    return [{"problem": f"How many chairs are visible? ({i})",
             "problem_type": "numerical", "solution": "<answer>3</answer>",
             "path": path, "data_type": "image", "data_source": "grpo",
             "problem_id": i,
             "prompt": [{"role": "user", "content": [
                 {"type": "image"},
                 {"type": "text",
                  "text": f"How many chairs are visible? ({i})"}]}]}
            for i in range(2)]


def _run_aria(out, mesh, rows):
    from spacer_tpu_torch.data.aria_processor import (
        AriaProcessor,
        MockAriaTokenizer,
    )
    from spacer_tpu_torch.models.aria import init_params, tiny_aria_config
    from spacer_tpu_torch.parallel.partition import (
        ARIA_PARTITION_RULES,
        shard_params,
    )
    from spacer_tpu_torch.rewards import format_reward
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

    cfg = tiny_aria_config()
    params = init_params(cfg, seed=0)
    if mesh is not None:
        params, _ = shard_params(params, mesh, ARIA_PARTITION_RULES)
    proc = AriaProcessor(MockAriaTokenizer(cfg.text.vocab_size), cfg,
                         max_image_size=56, min_image_size=14,
                         size_conversion={56: 8})
    args = SGRLVRConfig(num_generations=G, max_prompt_length=512,
                        max_completion_length=6, learning_rate=LR,
                        output_dir=os.path.join(out, "aria"),
                        prompt_bucket=64, remat=False, logp_chunk=16,
                        decode_quant=None, moment_dtype="float32", seed=5)
    trainer = SGRLVRTrainer(cfg, params, proc, [length_reward, format_reward,
                                                parity_reward], [], args,
                            mesh=mesh)
    m = trainer.training_step(rows, np.random.default_rng(1))
    return float(m["loss"]), *_full(trainer.params, trainer.opt_state)


# -- the spawned ranks ---------------------------------------------------------


def _worker(rank, out_dir, np_params_path, ckpt_dir):
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        shard_params,
    )

    world = multihost.process_count()
    # world 1 is the single-process reference: no mesh at all
    mesh = multihost.global_mesh() if world > 1 else None
    res = {}
    with open(np_params_path, "rb") as f:
        np_params = pickle.load(f)
    res["step"] = _run_grpo_step(np_params, mesh)
    res["rollout"] = _run_rollout(mesh)
    res["spec_rollout"] = _run_spec_rollout(np_params, mesh)
    if world == 4:
        # a data axis: shards summed over data, prompts split over data
        # alone where data x fsdp does not divide them
        data_mesh = create_mesh({"data": 2, "fsdp": 2})
        res["step_data"] = _run_grpo_step(np_params, data_mesh)
        res["rollout_data"] = _run_rollout(data_mesh)
        res["spec_rollout_data"] = _run_spec_rollout(np_params, data_mesh)

    cfg = tiny_config()

    def fresh_params():
        params = init_params(cfg, seed=0)
        if mesh is None:
            return params
        return shard_params(params, mesh, QWEN_PARTITION_RULES)[0]

    # world 4 keeps its shards' moments in host memory between updates
    trainer, rollouts = _sg_trainer(fresh_params(),
                                    os.path.join(out_dir, "sg"), mesh,
                                    offload_opt_state=world == 4)
    split = ROW_SPLITS[world]
    mine = _video_rows()[split[rank]:split[rank + 1]]
    rng = np.random.default_rng(0)
    metrics = [trainer.training_step(mine, rng) for _ in range(2)]
    res["trainer"] = ([{k: float(m[k]) for k in ("loss", "kl", "grad_norm")}
                       for m in metrics], rollouts,
                      *_full(trainer.params, trainer.opt_state))
    res["trainer_rewards"] = trainer._metrics["reward"]
    if world <= 2:
        if world == 2:
            trainer.global_step = 2
            trainer.save_checkpoint(ckpt_dir)
        res["sft"] = _run_sft(fresh_params(), os.path.join(out_dir, "sft"),
                              mesh)
        split = (0, 1, 2) if world == 2 else (0, 2)
        res["aria"] = _run_aria(out_dir, mesh, _aria_setup(out_dir)[
            split[rank]:split[rank + 1]])
    else:
        # restore the world-2 checkpoint onto this world
        fresh, _ = _sg_trainer(fresh_params(),
                               os.path.join(out_dir, "restored"), mesh,
                               offload_opt_state=True)
        fresh.load_checkpoint(ckpt_dir)
        res["restored"] = (fresh.global_step,
                           *_full(fresh.params, fresh.opt_state))
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(res, f)


# -- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1 in this process, then the world-2 and world-4 runs."""
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import init_params as jax_init
    from spacer_tpu.models.qwen25_vl import tiny_config as jax_tiny

    root = tmp_path_factory.mktemp("fsdp")
    np_params = jax.tree.map(np.asarray, jax_init(jax.random.key(0),
                                                  jax_tiny(), jnp.float32))
    np_path = root / "np_params.pkl"
    with open(np_path, "wb") as f:
        pickle.dump(np_params, f)
    out = {"np_params": np_params, "root": root}
    ckpt = root / "ckpt"
    # every rank (and the world-1 reference, run the same way) hashes the
    # mock tokenizer's words alike
    hashseed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        for world in (1, 2, 4):
            d = root / f"w{world}"
            d.mkdir()
            multihost.launch_local(_worker, world,
                                   args=(str(d), str(np_path), str(ckpt)),
                                   device="cpu", timeout=TIMEOUT, threads=1)
            with open(d / "result.pkl", "rb") as f:
                out[world] = pickle.load(f)
    finally:
        if hashseed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = hashseed
    out["ckpt"] = ckpt
    return out


# analytically zero gradients (a constant shift of a softmax row's logits
# changes nothing): all summation noise, tests/test_torch_aria_trainer.py
_ZERO_GRAD = ("self_attn/k_proj/bias", "mha_in_proj/bias")


def _close_params(got, ref, names=None):
    """Params after two updates at learning rate 1e-3 from gradients that
    differ in summation order only: 5e-6 absolute per element, except that
    Adam divides each element by its own gradient scale, so an element
    whose gradient sits at the summation-order noise may move by up to two
    learning rates: at most 1e-3 of a tensor's elements (at least 2) may,
    and the mean difference stays below 2e-7.  The key biases (`names`
    given), whose gradient is all noise, are held to the two-learning-rate
    bound alone."""
    for i, (a, b) in enumerate(zip(got, ref)):
        diff = np.abs(a - b)
        if names is not None and names[i].endswith(_ZERO_GRAD):
            assert diff.max() <= 2 * LR + 1e-6, names[i]
            continue
        assert (diff > 5e-6).sum() <= max(2, diff.size // 1000), i
        assert diff.max() <= 2 * LR + 1e-6, i
        assert diff.mean() <= 2e-7, i


def _close_moments(got, ref):
    """int8 moments: the payload codes equal for all but 1e-3 of a
    group's elements (at least 2: a value on a rounding tie, or a
    near-zero gradient's moment, may land one or more codes apart) and
    the per-block scales within 1e-4 relative (the block maxima carry the
    summation-order difference)."""
    for i, ((qa, sa), (qb, sb)) in enumerate(zip(got, ref)):
        off = (qa.astype(np.int32) != qb.astype(np.int32)).sum()
        assert off <= max(2, qa.size // 1000), (i, off)
        np.testing.assert_allclose(sa, sb, rtol=1e-4, atol=1e-30,
                                   err_msg=str(i))


@pytest.fixture(scope="module")
def jax_steps(runs):
    """JAX's single-device step, two updates on the same batch and numpy
    params -> (metrics per update, the updated params in the port's
    param_leaves order)."""
    import jax
    import jax.numpy as jnp

    from spacer_tpu.models.qwen25_vl import tiny_config as jax_tiny
    from spacer_tpu.train.optimizer import make_optimizer as jax_make_opt
    from spacer_tpu.train.step import make_grpo_train_step as jax_make_step
    from spacer_tpu_torch.models.qwen25_vl import params_from_jax
    from spacer_tpu_torch.models.qwen25_vl import tiny_config
    from spacer_tpu_torch.train.step import param_leaves

    os.environ["SPACER_ADAM8_SR"] = "off"
    try:
        cfg = jax_tiny()
        np_params = runs["np_params"]
        jtx = jax_make_opt(**STEP_OPT)
        jparams = jax.tree.map(jnp.asarray, np_params)
        jref = jax.tree.map(jnp.asarray, np_params)
        jstate = jtx.init(jparams)
        jstep = jax_make_step(cfg, jtx, beta=0.04, remat=True, logp_chunk=8)
        jb = {k: jnp.asarray(v) for k, v in _step_batch(cfg).items()}
        metrics = []
        for _ in range(2):
            with jax.default_matmul_precision("highest"):
                jparams, jstate, jm = jstep(
                    jparams, jref, jstate, jb, grid_thw=STEP_GRID * STEP_B,
                    num_generations=G, prompt_len=STEP_P,
                    grids_per_prompt=(1,) * STEP_B)
            metrics.append({k: float(jm[k]) for k in ("loss", "kl",
                                                      "grad_norm")})
    finally:
        del os.environ["SPACER_ADAM8_SR"]
    return metrics, [t.numpy() for _, t in param_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams), tiny_config()))]


@pytest.mark.parametrize("world,key", [(2, "step"), (4, "step"),
                                       (4, "step_data")])
def test_grpo_step_matches_world_one_and_jax(runs, jax_steps, world, key):
    """`step_data` runs at world 4 over a (data 2, fsdp 2) mesh."""
    m1, p1, mu1 = runs[1]["step"]
    mw, pw, muw = runs[world][key]
    for a, b in zip(mw, m1):
        for k in ("loss", "kl", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    _close_params(pw, p1)
    _close_moments(muw, mu1)
    jm, jleaves = jax_steps
    for a, b in zip(mw, jm):
        for k in ("loss", "kl", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-7), k
    for i, (a, b) in enumerate(zip(pw, jleaves)):
        diff = np.abs(a - b)
        assert (diff > 5e-6).sum() <= max(2, diff.size // 1000), i
        assert diff.max() <= 2e-4, i


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_steps_match_world_one(runs, world):
    m1, roll1, p1, mu1 = runs[1]["trainer"]
    mw, rollw, pw, muw = runs[world]["trainer"]
    assert len(roll1) == len(rollw) == 2
    for a, b in zip(rollw, roll1):
        np.testing.assert_array_equal(a, b)   # completions token for token
    assert runs[world]["trainer_rewards"] == runs[1]["trainer_rewards"]
    for a, b in zip(mw, m1):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5, abs=1e-5)
        assert a["kl"] == pytest.approx(b["kl"], rel=1e-5, abs=1e-7)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
    _close_params(pw, p1)
    _close_moments(muw, mu1)


def test_sft_and_aria_at_world_two(runs):
    l1, p1, _ = runs[1]["sft"]
    l2, p2, _ = runs[2]["sft"]
    assert l2 == pytest.approx(l1, rel=1e-5)
    _close_params(p2, p1)
    from spacer_tpu_torch.models.aria import init_params, tiny_aria_config
    from spacer_tpu_torch.train.step import param_leaves

    names = [n for n, _ in param_leaves(init_params(tiny_aria_config()))]
    a1, ap1, _ = runs[1]["aria"]
    a2, ap2, _ = runs[2]["aria"]
    assert a2 == pytest.approx(a1, rel=1e-5, abs=1e-6)
    _close_params(ap2, ap1, names)


@pytest.mark.parametrize("world", [1, 4])
def test_checkpoint_restores_across_worlds(runs, world, tmp_path):
    """Saved at world 2, restored at `world`: every param and moment
    bitwise as saved."""
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.train.step import param_leaves

    ckpt = runs["ckpt"]
    saved = torch.load(ckpt / "params.pt", weights_only=False)
    state = torch.load(ckpt / "opt_state.pt", weights_only=False)
    want_p = [t.detach().numpy() for _, t in param_leaves(saved)]
    want_m = [tuple(x.numpy() for x in pair) for pair in state.mu + state.nu]
    if world == 1:
        trainer, _ = _sg_trainer(init_params(tiny_config(), seed=0),
                                 tmp_path)
        trainer.load_checkpoint(str(ckpt))
        step, got_p, got_m = trainer.global_step, *_full(trainer.params,
                                                         trainer.opt_state)
    else:
        step, got_p, got_m = runs[world]["restored"]
    assert step == 2
    # the checkpoint holds world 2's gathered params and moments
    _, _, p2, mu2 = runs[2]["trainer"]
    for a, b, c in zip(got_p, want_p, p2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    for (qa, sa), (qb, sb) in zip(got_m, want_m):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(sa, sb)
    assert len(want_m) == len(mu2)


def test_train_sg_rlvr_cli_under_torchrun(tmp_path):
    """The entry point under a 2-process torchrun launch on the CPU: gloo,
    the params sharded over fsdp 2, rank 0 writing the metrics and the
    final checkpoint."""
    import cv2

    rows = [{"problem": f"How many chairs? ({i})",
             "problem_type": "numerical", "solution": "<answer>3</answer>",
             "path": str(tmp_path / "clip.mp4"), "data_type": "video",
             "data_source": "SR_dataset", "problem_id": i} for i in range(2)]
    w = cv2.VideoWriter(str(tmp_path / "clip.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (128, 96))
    base = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    for t in range(60):
        w.write(np.roll(base, 2 * t, axis=1))
    w.release()
    with open(tmp_path / "train.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with open(tmp_path / "cogmap.jsonl", "w") as f:
        f.write(json.dumps({"video_id": "clip", "cognitive_map": {},
                            "object_list": []}) + "\n")
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "2", "--standalone", "-m", "spacer_tpu_torch.cli.train_sg_rlvr",
           "--multihost", "true", "--device", "cpu",
           "--dataset_name", str(tmp_path / "train.jsonl"),
           "--cognitive_map_path", str(tmp_path / "cogmap.jsonl"),
           "--random_init", "true", "--dtype", "float32",
           "--output_dir", str(out), "--max_steps", "1",
           "--rollout_batch_size", "2", "--num_generations", "2",
           "--max_prompt_length", "512", "--max_completion_length", "4",
           "--prompt_bucket", "64", "--logp_chunk", "4"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(recs) == 1 and recs[0]["step"] == 1
    assert np.isfinite(recs[0]["loss"])
    assert os.path.exists(out / "final" / "params.pt")


@pytest.mark.parametrize("world,key", [(2, "rollout"), (4, "rollout"),
                                       (4, "rollout_data")])
def test_sharded_rollout_matches_world_one(runs, world, key):
    """The grouped rollout over a mesh gives every rank every row, token
    for token as one process samples them at temperature 1: 2 prompts
    split over data x fsdp at world 2, kept whole at world 4 over fsdp 4
    (2 do not divide 4), split over data alone over (data 2, fsdp 2)."""
    np.testing.assert_array_equal(runs[world][key], runs[1]["rollout"])


@pytest.mark.parametrize("world,key", [(2, "spec_rollout"),
                                       (4, "spec_rollout"),
                                       (4, "spec_rollout_data")])
def test_speculative_rollout_over_split_rows_matches_world_one(runs, world,
                                                               key):
    """The speculative rollout (k = 2) over a mesh: 2 prompts split over
    data x fsdp at world 2, whole at world 4 over fsdp 4, split over data
    alone over (data 2, fsdp 2).  Greedy and at temperature 1, every rank
    returns one process's tokens and acceptance counts exactly, and the
    greedy tokens are JAX's speculative sampler's."""
    import jax

    from spacer_tpu.models.qwen25_vl import tiny_config as jax_tiny
    from spacer_tpu.sampler import Sampler as JaxSampler

    got, ref = runs[world][key], runs[1]["spec_rollout"]
    for temp in (0.0, 1.0):
        np.testing.assert_array_equal(got[temp][0], ref[temp][0])
        assert got[temp][1] == ref[temp][1]
    assert ref[0.0][1]["spec_acceptance"] > 1.0
    ids, mask, pos, deltas = _spec_prompts(jax_tiny().text.vocab_size)
    want = JaxSampler(jax_tiny(), eos_token_id=11, pad_token_id=0,
                      length_bucket=8, speculate_k=2).generate(
        ids, mask, jax.tree.map(np.asarray, runs["np_params"]),
        position_ids=pos, deltas=deltas, temperature=0.0, **SPEC_KW)
    mask_j = np.asarray(want.completion_mask)
    np.testing.assert_array_equal(ref[0.0][0] * mask_j,
                                  np.asarray(want.sequences) * mask_j)
