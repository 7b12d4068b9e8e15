"""A copy of the benchmark at tiny sizes for the CPU tests: the real files
under a temporary root, with tiny configurations, short traffic mixes and a
BENCHMARK.json that names them."""

from __future__ import annotations

import copy
import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent

QWEN = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "rope_scaling": {"type": "mrope", "mrope_section": [4, 2, 2]},
    "tie_word_embeddings": False, "vocab_size": 1024,
    "vision_start_token_id": 4, "vision_end_token_id": 5, "image_token_id": 6,
    "video_token_id": 7,
    "vision_config": {"depth": 4, "hidden_size": 32, "intermediate_size": 64,
                      "num_heads": 2, "out_hidden_size": 64, "patch_size": 14,
                      "spatial_merge_size": 2, "window_size": 112,
                      "fullatt_block_indexes": [1, 3], "tokens_per_second": 2,
                      "temporal_patch_size": 2}}
ARIA = {"text_config": {
    "hidden_size": 64, "intermediate_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "max_position_embeddings": 512,
    "tie_word_embeddings": False, "attention_bias": False, "moe_num_experts": 8,
    "moe_topk": 2, "moe_num_shared_experts": 2, "vocab_size": 1024}}


def make(root: pathlib.Path) -> pathlib.Path:
    """A benchmark root under `root` with the tiny cells; -> its perfbench."""
    bench = root / "perfbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    tiny = copy.deepcopy(real)
    qc = json.loads((bench / "configs/qwen25vl7b.json").read_text())
    ac = json.loads((bench / "configs/aria25b.json").read_text())
    qc.update(model=QWEN, eos_token_id=2, pad_token_id=0, text_ids=[10, 1024])
    ac.update(model=ARIA, eos_token_id=2, pad_token_id=2, text_ids=[10, 1024])
    # at these widths a router this narrow keeps bf16 and float32 on the same
    # tokens (about 3 % differ), and float8 off them (25-38 %)
    ac["assumed"]["router_logit_std"] = 1.0
    (bench / "configs/qwen_tiny.json").write_text(json.dumps(qc))
    (bench / "configs/aria_tiny.json").write_text(json.dumps(ac))
    vq = json.loads((bench / "traffic/video_qa.json").read_text())
    vq["prompt"].update(grid_hw=[4, 6], prefix_tokens=3, suffix_tokens=2)
    vq["fields"].update(video_frames={"kind": "choice", "values": [2, 4]},
                        question_tokens={"kind": "uniform_int", "low": 4, "high": 16},
                        max_new_tokens={"kind": "loguniform_int", "low": 2, "high": 12})
    vq["arrivals"]["rate_per_s"] = 20.0
    vq["serving"].update(slots=4, prompt_len=64, max_new_tokens=12, chunk_steps=4)
    vq["warmup"].update(requests=4, wave=2, max_new_tokens=2)
    vq["drain_seconds"] = 60
    ld = json.loads((bench / "traffic/longdoc_offline.json").read_text())
    ld["fields"].update(prompt_tokens={"kind": "loguniform_int", "low": 16, "high": 48},
                        max_new_tokens={"kind": "uniform_int", "low": 2, "high": 8})
    ld["arrivals"].update(queue_depth=4, expected_requests_per_s=400)
    ld["serving"].update(slots=2, prompt_len=64, max_new_tokens=8, chunk_steps=4)
    ld["warmup"].update(requests=2, wave=2, max_new_tokens=2)
    (bench / "traffic/video_qa_tiny.json").write_text(json.dumps(vq))
    (bench / "traffic/longdoc_tiny.json").write_text(json.dumps(ld))
    lims = {"qwen_tiny.video_qa_tiny": {"widest_gap": 0.3},
            "aria_tiny.longdoc_tiny": {"mean_gap": 0.04}}
    names = {"qwen25vl7b.video_qa": ("qwen_tiny.video_qa_tiny", "qwen_tiny", "video_qa_tiny"),
             "aria25b.longdoc_offline": ("aria_tiny.longdoc_tiny", "aria_tiny", "longdoc_tiny")}
    for old, (new, cfg, tr) in names.items():
        (bench / "limits" / f"{new}.json").write_text(json.dumps(
            dict(lims[new], min_served_tokens=100, max_requests=16)))
        for w in tiny["workloads"]:
            if w["name"] == old:
                w.update(name=new, config=cfg, traffic=tr)
        for m in tiny["end_to_end"] + tiny["per_layer"]:
            if "workloads" in m:
                m["workloads"] = [names[x][0] if x in names else x for x in m["workloads"]]
    tiny["configs"] = [dict(c, name=n, file=f"perfbench/configs/{n}.json")
                       for c, n in zip(real["configs"], ("qwen_tiny", "aria_tiny"))]
    (root / "BENCHMARK.json").write_text(json.dumps(tiny, indent=1))
    return bench
