"""The SG-RLVR trainer of spacer_tpu_torch at tiny size on the CPU: two
optimizer steps through `train()` (merged temporal rollout, rewards, group
advantages, reference logps, shared-prefix update with int8 moments), a
checkpoint round trip, one step at the default config (int8_kv rollouts),
the configurations the port does not run, and the copied reward functions
against spacer_tpu.rewards on sample strings (exact equality: the same
pure-Python code).
"""

import json
import os

import numpy as np
import pytest
import torch

from spacer_tpu_torch.data import MockTokenizer, VLProcessor, make_conversation
from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
from spacer_tpu_torch.rewards import format_reward
from spacer_tpu_torch.train.step import param_leaves
from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer


def length_reward(completions, **kwargs):
    """A reward that varies over completions of a random model (whose
    accuracy reward is 0 everywhere): the completion's length mod 5."""
    return [float(len(c[0]["content"]) % 5) for c in completions]


def parity_reward(completions, **kwargs):
    """A reward that keeps neighbouring completions of a group apart
    whatever they say: 0.5 at odd positions, so that with the integer
    rewards beside it a total at an odd position is never one at an even
    one.  The mock tokenizer's word ids come from Python's per-process
    string hash, so the prompt, and with it a random model's completions,
    changes with PYTHONHASHSEED; for some seeds length_reward alone ties
    across a whole group (zero advantages, a zero gradient)."""
    return [0.5 * (i % 2) for i in range(len(completions))]


def _rows():
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    row = {"problem": "How many chairs are visible?",
           "problem_type": "numerical", "solution": "<answer>3</answer>",
           "path": frames, "data_type": "video", "data_source": "synthetic",
           "problem_id": 0}
    row.update(make_conversation(row))
    return [row]


def _trainer(tmp_path, **over):
    cfg = tiny_config()
    params = init_params(cfg, seed=0, dtype=torch.float32)
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)
    kw = dict(num_generations=4, max_prompt_length=512,
              max_completion_length=8, learning_rate=1e-3, max_steps=2,
              num_train_epochs=2,
              logging_steps=1, save_steps=100, prompt_bucket=64,
              logp_chunk=8, decode_quant=None, moment_dtype="int8",
              output_dir=str(tmp_path / "out"), seed=3)
    kw.update(over)
    return SGRLVRTrainer(cfg, params, proc,
                         [length_reward, format_reward, parity_reward],
                         _rows(), SGRLVRConfig(**kw))


def test_two_training_steps_and_checkpoint(tmp_path):
    trainer = _trainer(tmp_path)
    before = [t.detach().clone() for _, t in param_leaves(trainer.params)]
    trainer.train()
    assert trainer.global_step == 2
    records = [json.loads(line) for line in
               open(os.path.join(trainer.args.output_dir, "metrics.jsonl"))]
    assert len(records) == 2
    for rec in records:
        for key in ("loss", "kl", "grad_norm", "reward"):
            assert np.isfinite(rec[key]), key
        assert rec["grad_norm"] > 0
        assert "rewards/length_reward" in rec and "temporal_rewards" in rec
        assert rec["time/rollout_s"] > 0
    after = [t for _, t in param_leaves(trainer.params)]
    moved = [name for (name, _), a, b in zip(param_leaves(trainer.params),
                                             before, after)
             if not torch.equal(a, b)]
    assert any(n.startswith("visual/") for n in moved)
    assert any(n.startswith("model/layers/") for n in moved)
    assert trainer.opt_state.count == 2
    assert any(bool(q.any()) for q, _ in trainer.opt_state.mu)  # int8 moments

    ckpt = trainer.save_checkpoint()
    params = [t.clone() for _, t in param_leaves(trainer.params)]
    mu = [q.clone() for q, _ in trainer.opt_state.mu]
    trainer.global_step = 0
    for _, t in param_leaves(trainer.params):
        t.data.zero_()
    trainer.load_checkpoint(ckpt)
    assert trainer.global_step == 2 and trainer.opt_state.count == 2
    for a, (_, b) in zip(params, param_leaves(trainer.params)):
        assert torch.equal(a, b)
    for a, (b, _) in zip(mu, trainer.opt_state.mu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("over", [
    dict(decode_quant="int2"), dict(decode_quant="int4_v"),
    dict(mesh=object()), dict(attn_impl="xla"), dict(decode_impl="flash_ref"),
    dict(attn_impl="pallas"), dict(decode_impl="flash"),
    dict(decode_impl="xla"), dict(mesh={"data": 1, "fsdp": 1, "tp": 2})])
def test_unported_configurations_raise(tmp_path, over):
    """Unknown decode_quant values raise ValueError (as in the JAX
    sampler) and a mesh that is not the port's parallel.mesh.Mesh
    TypeError, and a tp that does not divide Aria's heads ValueError (a
    Qwen and an Aria trainer take a tp-2 mesh since tensor parallelism was
    ported: tests/test_torch_tp_model.py, tests/test_torch_aria_tp.py); the
    configurations the port does not run NotImplementedError: any
    attn_impl / decode_impl (gradient
    accumulation, offload, speculative rollouts and the data x fsdp mesh
    run since they were ported: tests/test_torch_accumulation.py,
    test_torch_offload.py, test_speculative_rollout_step below,
    test_torch_fsdp_trainer.py)."""
    if isinstance(over.get("mesh"), dict):
        from spacer_tpu_torch.models.aria import init_params as aria_init
        from spacer_tpu_torch.models.aria import tiny_aria_config
        from spacer_tpu_torch.parallel.mesh import Mesh

        cfg = tiny_config()
        mesh = Mesh(over["mesh"], rank=0)
        trainer = SGRLVRTrainer(
            cfg, init_params(cfg), VLProcessor(
                MockTokenizer(vocab_size=cfg.text.vocab_size), cfg),
            [format_reward], _rows(), SGRLVRConfig(), mesh=mesh)
        assert trainer.sampler.mesh is mesh
        from spacer_tpu_torch.data.aria_processor import (
            AriaProcessor,
            MockAriaTokenizer,
        )

        aria = tiny_aria_config()
        proc = AriaProcessor(MockAriaTokenizer(aria.text.vocab_size), aria)
        trainer = SGRLVRTrainer(aria, aria_init(aria), proc, [format_reward],
                                _rows(), SGRLVRConfig(), mesh=mesh)
        assert trainer.sampler.mesh is mesh
        # the tiny tower's 2 heads: tp 4 does not divide them
        with pytest.raises(ValueError, match="tower's num_heads=2"):
            SGRLVRTrainer(aria, aria_init(aria), proc, [format_reward],
                          _rows(), SGRLVRConfig(),
                          mesh=Mesh(dict(over["mesh"], tp=4), rank=0))
        return
    exc = (ValueError if "decode_quant" in over
           else TypeError if "mesh" in over
           and not isinstance(over["mesh"], dict)
           else NotImplementedError)
    with pytest.raises(exc):
        if "mesh" in over:
            from spacer_tpu_torch.parallel.mesh import Mesh

            cfg = tiny_config()
            mesh = over["mesh"]
            if isinstance(mesh, dict):
                mesh = Mesh(mesh, rank=0)
            SGRLVRTrainer(cfg, init_params(cfg), VLProcessor(
                MockTokenizer(vocab_size=cfg.text.vocab_size), cfg),
                [format_reward], _rows(), SGRLVRConfig(), mesh=mesh)
        else:
            _trainer(tmp_path, **over)


@pytest.mark.parametrize("quant", [None, "int8_kv"])
def test_speculative_rollout_step(tmp_path, quant):
    """speculate_k reaches the rollout sampler: one optimizer step with
    speculative rollouts, finite metrics, the acceptance logged."""
    trainer = _trainer(tmp_path, speculate_k=2, decode_quant=quant,
                       max_steps=1, num_train_epochs=1)
    assert trainer.sampler.speculate_k == 2
    trainer.train()
    rec = json.loads(open(os.path.join(trainer.args.output_dir,
                                       "metrics.jsonl")).readline())
    assert np.isfinite(rec["loss"]) and rec["grad_norm"] > 0
    assert rec["spec_acceptance"] >= 1.0


def test_default_config_raises_for_quantised_rollouts(tmp_path, capsys):
    """The default config (the JAX default, int8_kv rollouts) no longer
    raises: it takes an optimizer step, with the JAX trainer's notice."""
    assert SGRLVRConfig().decode_quant == "int8_kv"
    cfg = tiny_config()
    proc = VLProcessor(MockTokenizer(vocab_size=cfg.text.vocab_size), cfg)
    trainer = SGRLVRTrainer(
        cfg, init_params(cfg, seed=0), proc, [length_reward, format_reward],
        _rows(), SGRLVRConfig(
            num_generations=2, max_completion_length=4, prompt_bucket=64,
            logp_chunk=4, max_steps=1, output_dir=str(tmp_path / "out")))
    assert trainer.sampler.decode_quant == "int8_kv"
    assert "rollout decode quantized" in capsys.readouterr().out
    trainer.train()
    assert trainer.global_step == 1 and trainer.opt_state.count == 1


SAMPLES = [
    "<think>two chairs by the table</think><answer>3</answer>",
    "<think>x</think>\n<answer>3.5</answer>",
    "<answer>B</answer>",
    "no tags at all",
    "<think>map</think><map>{\"chair\": [[1, 2]], \"table\": [[8, 8]]}</map>"
    "<answer>4</answer>",
]
PROBLEMS = [("numerical", "<answer>3</answer>"),
            ("multiple choice", "<answer>B</answer>"),
            ("regression", "<answer>3.2</answer>")]


def test_rewards_match_spacer_tpu():
    import spacer_tpu.rewards as jr
    import spacer_tpu_torch.rewards as tr

    comps = [[{"content": s}] for s in SAMPLES]
    assert tr.format_reward(comps) == jr.format_reward(comps)
    for s in SAMPLES:
        assert tr.extract_answer(s) == jr.extract_answer(s)
        assert tr.extract_map_tag(s) == jr.extract_map_tag(s)
    map_data = {"clip": {"cognitive_map": {"chair": [[1, 2]], "table": [[8, 8]]},
                         "object_list": ["chair", "table"]}}
    for (qtype, sol), maps in zip(PROBLEMS, (map_data, None, map_data)):
        kw = dict(path=["clip.mp4"] * len(comps), map_data=maps,
                  problem_type=[qtype])
        assert (tr.accuracy_reward(comps, [sol] * len(comps), **kw)
                == jr.accuracy_reward(comps, [sol] * len(comps), **kw)), qtype
    objects = ["chair", "table"]
    for s in SAMPLES:
        assert (tr.extract_map_data(s, objects)
                == jr.extract_map_data(s, objects))


def test_accumulated_offloaded_step_over_unequal_videos(tmp_path):
    """gradient_accumulation_steps=2 with offloaded optimizer state, two
    videos of unequal frame size in one rollout (rollout_batch_size=2: one
    ViT call over mixed grids, the merged rollout holding 4 prompts): the
    first call leaves the params bitwise as they were and the state in
    host memory, the second applies the mean and moves them."""
    from spacer_tpu_torch.parallel import is_on_host

    rows = _rows()
    big = np.random.default_rng(1).integers(0, 256, (4, 84, 112, 3), np.uint8)
    rows.append(dict(rows[0], path=big, problem_id=1))
    trainer = _trainer(tmp_path, gradient_accumulation_steps=2,
                       offload_opt_state=True, rollout_batch_size=2,
                       max_steps=2, num_train_epochs=2)
    trainer.dataset = rows
    assert is_on_host(trainer.opt_state)
    grids = []
    generate = trainer.sampler.generate

    def recorded(*a, **kw):
        grids.append(kw["grid_thw"])
        return generate(*a, **kw)

    trainer.sampler.generate = recorded
    before = [t.detach().clone() for _, t in param_leaves(trainer.params)]
    trainer.args.max_steps = 1
    trainer.train()
    assert trainer.opt_state.mini_step == 1
    assert trainer.opt_state.inner_opt_state.count == 0
    assert is_on_host(trainer.opt_state)
    for a, (_, b) in zip(before, param_leaves(trainer.params)):
        assert torch.equal(a, b)
    trainer.args.max_steps = 2
    trainer.train()
    assert trainer.global_step == 2
    st = trainer.opt_state
    assert (st.mini_step, st.gradient_step, st.inner_opt_state.count) == (0, 1, 1)
    moved = [n for (n, t), a in zip(param_leaves(trainer.params), before)
             if not torch.equal(a, t)]
    assert any(n.startswith("visual/") for n in moved)
    assert any(n.startswith("model/layers/") for n in moved)
    # 2 main + 2 temporal-shuffle prompts in one rollout; frame chunks of
    # 24 and 48 patches: mixed grids in one ViT call
    assert len(grids[0]) == 4
    assert len({h * w for _, h, w in grids[0]}) == 2
    # a resume restores the offloaded state into its own host tensors
    ckpt = trainer.save_checkpoint()
    acc = [a.clone() for a in st.acc_grads]
    ids = [id(a) for a in st.acc_grads]
    for a in st.acc_grads:
        a.fill_(1.0)
    trainer.load_checkpoint(ckpt)
    st = trainer.opt_state
    assert is_on_host(st) and [id(a) for a in st.acc_grads] == ids
    assert all(torch.equal(a, b) for a, b in zip(acc, st.acc_grads))
    assert (st.mini_step, st.gradient_step) == (0, 1)
