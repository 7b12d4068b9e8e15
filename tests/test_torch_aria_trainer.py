"""The SG-RLVR trainer with the Aria family: spacer_tpu_torch's
SGRLVRTrainer against spacer_tpu's on the setup of
tests/test_aria_trainer_e2e.py (two image rows over a png, tiny_aria_config,
56-pixel crops of 8 projector queries, G = 4), on the same converted
float32 weights, two optimizer steps through `train()`.

The rollouts are greedy (temperature 0, decode_quant None), so both
packages decode the same completions, which the test checks.  The G greedy
completions of a prompt are equal, though, and equal completions give a
zero policy gradient (the advantages sum to 0), so each rollout's
completions are then replaced, in both trainers alike, by the same fixed
random ones (with EOS at different places) before the rewards and the
update.  The moments are float32 (the int8 moments' rounding ties are
tests/test_torch_train_step.py's subject).

Tolerances: each step's loss, kl, reward and grad_norm 1e-4 relative (f32
sums in another order).  Params after the two steps: 5e-6 absolute per
element, except that Adam divides each element by its own gradient scale,
so an element whose gradient sits at the summation-order noise (~1e-7 of
the largest) may take an update of either sign: at most 1e-3 of a tensor's
elements (at least 2) may differ, each by at most two learning rates, and
the mean difference stays below 2e-7.  The key biases (the ViT's k_proj,
and the projector's in-projection bias, whose middle third is its key
bias) get an analytically zero gradient, since a constant shift of a
softmax row's logits changes nothing: their gradient is all summation
noise, so they are held to the two-learning-rate bound alone.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.data.aria_processor import AriaProcessor as JaxAriaProcessor
from spacer_tpu.data.aria_processor import MockAriaTokenizer as JaxTokenizer
from spacer_tpu.models import aria as jaria
from spacer_tpu.rewards import format_reward as jax_format_reward
from spacer_tpu.train.trainer import SGRLVRConfig as JaxConfig
from spacer_tpu.train.trainer import SGRLVRTrainer as JaxTrainer
from spacer_tpu_torch.data.aria_processor import AriaProcessor, MockAriaTokenizer
from spacer_tpu_torch.models.aria import tiny_aria_config
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.rewards import format_reward
from spacer_tpu_torch.train.step import param_leaves
from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer

LR = 1e-4
PROC_KW = dict(max_image_size=56, min_image_size=14, size_conversion={56: 8})


def length_reward(completions, **kwargs):
    """A reward that varies over completions of a random model (whose
    accuracy reward is 0 everywhere): the completion's length mod 5."""
    return [float(len(c[0]["content"]) % 5) for c in completions]


def fixed_completions(trainer, rollouts: list, eos: int):
    """Wrap the trainer's sampler: record each greedy rollout's sequences,
    then hand the trainer fixed random completions of the same shape (a
    step's own seed, so both packages get the same)."""
    generate = trainer.sampler.generate

    def wrapped(*a, **kw):
        out = generate(*a, **kw)
        rollouts.append(np.asarray(out.sequences))
        n, C = out.sequences.shape
        rng = np.random.default_rng(len(rollouts))
        seqs = rng.integers(10, 1000, (n, C))
        for row, end in enumerate(rng.integers(2, C + 2, n)):
            if end < C:
                seqs[row, end] = eos
        mask = (np.arange(C)[None] <= np.where(
            (seqs == eos).any(1), (seqs == eos).argmax(1), C)[:, None])
        return type(out)(sequences=seqs, completion_mask=mask.astype(np.int32),
                         lengths=mask.sum(1))

    trainer.sampler.generate = wrapped


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    from PIL import Image

    path = str(tmp_path_factory.mktemp("img") / "scene.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (120, 160, 3), np.uint8)).save(path)
    return path


def _dataset(image_path):
    return [{"problem": f"How many chairs are visible? ({i})",
             "problem_type": "numerical", "solution": "<answer>3</answer>",
             "path": image_path, "data_type": "image", "data_source": "grpo",
             "problem_id": i,
             "prompt": [{"role": "user", "content": [
                 {"type": "image"},
                 {"type": "text",
                  "text": f"How many chairs are visible? ({i})"}]}]}
            for i in range(2)]


def _args(cls, out, **extra):
    return cls(num_generations=4, max_prompt_length=512,
               max_completion_length=12, learning_rate=LR, temperature=0.0,
               temporal=True, len_control=True, max_steps=2, logging_steps=1,
               save_steps=100, output_dir=str(out), prompt_bucket=64,
               remat=False, logp_chunk=16, decode_quant=None,
               moment_dtype="float32", **extra)


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_aria_trainer_two_steps_match_jax(image_path, tmp_path):
    cfg = tiny_aria_config()
    np_params = jax.tree.map(np.asarray, jaria.init_params(
        jax.random.key(0), cfg, jnp.float32))
    r = np_params["model"]["layers"]["mlp"]["router"]
    r["kernel"] = np.random.default_rng(1).normal(
        0, 0.5, r["kernel"].shape).astype(np.float32)
    dataset = _dataset(image_path)

    jtrainer = JaxTrainer(
        cfg, jax.tree.map(jnp.asarray, np_params), JaxAriaProcessor(
            JaxTokenizer(cfg.text.vocab_size), cfg, **PROC_KW),
        [length_reward, jax_format_reward], dataset,
        _args(JaxConfig, tmp_path / "jax", attn_impl="xla"))
    jrollouts, rollouts = [], []
    fixed_completions(jtrainer, jrollouts, cfg.eos_token_id)
    jtrainer.train()
    trainer = SGRLVRTrainer(
        cfg, params_from_jax(np_params, cfg), AriaProcessor(
            MockAriaTokenizer(cfg.text.vocab_size), cfg, **PROC_KW),
        [length_reward, format_reward], dataset,
        _args(SGRLVRConfig, tmp_path / "torch"))
    fixed_completions(trainer, rollouts, cfg.eos_token_id)
    before = [t.detach().clone() for _, t in param_leaves(trainer.params)]
    trainer.train()
    assert trainer.global_step == jtrainer.global_step == 2, (
        f"global_step: port {trainer.global_step}, JAX "
        f"{jtrainer.global_step}, want 2")
    assert len(rollouts) == len(jrollouts) == 2, (
        f"rollouts: port {len(rollouts)}, JAX {len(jrollouts)}, want 2")
    for step, (got, ref) in enumerate(zip(rollouts, jrollouts), 1):
        np.testing.assert_array_equal(
            got, ref, err_msg=f"step {step} rollout tokens: port {got!r}, "
            f"JAX {ref!r}")

    recs, jrecs = _records(tmp_path / "torch"), _records(tmp_path / "jax")
    assert len(recs) == len(jrecs) == 2, (
        f"metrics records: port {len(recs)}, JAX {len(jrecs)}, want 2")
    for step, (rec, jrec) in enumerate(zip(recs, jrecs), 1):
        assert rec["completion_length"] == jrec["completion_length"], (
            f"step {step} completion_length: port "
            f"{rec['completion_length']!r}, JAX {jrec['completion_length']!r}")
        for key in ("loss", "kl", "reward", "grad_norm"):
            np.testing.assert_allclose(
                rec[key], jrec[key], rtol=1e-4, atol=1e-7,
                err_msg=f"step {step} {key}: port {rec[key]!r}, JAX "
                f"{jrec[key]!r}")
    assert recs[0]["grad_norm"] > 0, (
        f"step 1 grad_norm: port {recs[0]['grad_norm']!r}, JAX "
        f"{jrecs[0]['grad_norm']!r}, want > 0")

    jleaves = param_leaves(params_from_jax(
        jax.tree.map(np.asarray, jtrainer.params), cfg))
    moved = 0
    for (name, t), (_, ref), b in zip(param_leaves(trainer.params), jleaves,
                                      before):
        got = t.detach().numpy()
        diff = np.abs(got - ref.numpy())
        worst = np.unravel_index(int(diff.argmax()), diff.shape)
        where = (f"after step 2, param {name}: at {worst} port "
                 f"{got[worst]!r}, JAX {ref.numpy()[worst]!r}")
        assert diff.max() <= 2 * LR, (
            f"{where}; max diff {diff.max()!r} > {2 * LR!r}")
        if not name.endswith(("k_proj/bias", "mha_in_proj/bias")):
            assert (diff > 5e-6).sum() <= max(2, diff.size // 1000), (
                f"{where}; {int((diff > 5e-6).sum())} of {diff.size} "
                "elements past 5e-6")
            assert diff.mean() <= 2e-7, (
                f"{where}; mean diff {diff.mean()!r} > 2e-7")
        moved += not torch.equal(t, b)
    # every tensor moved but the experts no token was routed to
    assert moved > len(before) // 2, (
        f"after step 2: {moved} of {len(before)} port tensors moved, want "
        f"> {len(before) // 2}")
