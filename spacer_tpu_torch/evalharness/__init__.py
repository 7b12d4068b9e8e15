"""Multi-benchmark video evaluation harness (counterpart of
spacer_tpu/evalharness; SpaceR-Eval's evaluate.py orchestrator, util.py
frame loader and data_utils/* workers and scorers).  The six benchmark
modules, util.py and text_tasks.py are copies of the JAX package's; the
engine runs the port's sampler and continuous batcher."""

from spacer_tpu_torch.evalharness.engine import EchoEngine, QwenEngine
from spacer_tpu_torch.evalharness.runner import (
    SUPPORTED_TASKS,
    EvalConfig,
    run_benchmark,
    score_results,
)
from spacer_tpu_torch.evalharness.util import (
    extract_answer_text,
    format_time,
    load_video_frames,
    merge_results,
)

__all__ = [
    "EvalConfig", "SUPPORTED_TASKS", "run_benchmark", "score_results",
    "extract_answer_text", "format_time", "load_video_frames",
    "merge_results", "QwenEngine", "EchoEngine",
]
