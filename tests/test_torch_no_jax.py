"""spacer_tpu_torch stands alone: no module of it (nor the scripts that
drive it on the card, chip_smoke.py, profile_train.py and profile_serve.py)
imports jax or spacer_tpu, and the tiny serving slice and one tiny SG-RLVR
training step run on the CPU through the kernels' plain versions (no
kernel launch is counted there)."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "spacer_tpu_torch"

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "spacer_tpu"):
        sys.modules[name] = None          # any import of these now fails
    import numpy as np
    import spacer_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        spacer_tpu_torch.__path__, "spacer_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from spacer_tpu_torch.cli.common import ModelArgs, load_model_and_processor
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, params, proc = load_model_and_processor(
        ModelArgs(random_init=True, dtype="float32", device="cpu"))
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    msgs = [[{"role": "user", "content": [
                {"type": "video", "video": frames, "fps": 2.0},
                {"type": "text", "text": "what moves"}]}],
            [{"role": "user", "content": "hello"}]]
    reset_launch_counts()
    texts = QwenEngine(cfg, params, proc, length_bucket=64).generate_many(
        msgs, max_new_tokens=4, temperature=0.0, slots=2)
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    assert set(launch_counts().values()) == {0}, launch_counts()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("imported", len(names), "modules")
""")


TRAIN_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    for name in ("jax", "jaxlib", "spacer_tpu"):
        sys.modules[name] = None
    import numpy as np
    from spacer_tpu_torch.cli.common import ModelArgs, load_model_and_processor
    from spacer_tpu_torch.data import make_conversation
    from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
    from spacer_tpu_torch.rewards import format_reward
    from spacer_tpu_torch.train.trainer import SGRLVRConfig, SGRLVRTrainer
    cfg, params, proc = load_model_and_processor(
        ModelArgs(random_init=True, dtype="float32", device="cpu"))
    frames = np.random.default_rng(0).integers(0, 256, (4, 56, 84, 3), np.uint8)
    row = {"problem": "how many", "problem_type": "numerical",
           "solution": "<answer>1</answer>", "path": frames,
           "data_type": "video", "data_source": "synthetic"}
    row.update(make_conversation(row))
    args = SGRLVRConfig(num_generations=2, max_completion_length=4,
                        prompt_bucket=64, logp_chunk=4, decode_quant=None,
                        output_dir=tempfile.mkdtemp())
    reset_launch_counts()
    trainer = SGRLVRTrainer(cfg, params, proc, [format_reward], [row], args)
    m = trainer.training_step([row], np.random.default_rng(0))
    assert np.isfinite(float(m["loss"])), m
    assert set(launch_counts().values()) == {0}, launch_counts()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "spacer_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("trained")
""")


def _run(script, marker):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert marker in res.stdout


def test_port_imports_no_jax_and_runs_on_cpu():
    _run(SCRIPT, "imported")


def test_training_step_runs_without_jax_on_cpu():
    _run(TRAIN_SCRIPT, "trained")


def test_no_jax_or_spacer_tpu_import_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|spacer_tpu)(\.|\s|$)",
                         re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py",
               REPO / "profile_train.py", REPO / "profile_serve.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
