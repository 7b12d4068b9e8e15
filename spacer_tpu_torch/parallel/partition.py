"""Parameter partitioning and batch placement (counterpart of
spacer_tpu/parallel/partition.py).

The rule tables are the JAX package's, as data: regexes over 'a/b/c' param
paths, first match wins, each naming a spec (a tuple of mesh axis names or
None per dim).  The port keeps per-layer tensors ("model/layers/<i>/...",
"visual/blocks/<i>/...", "visual/encoder/<i>/...") where JAX stacks them
on a leading layer axis, so a path is matched with its layer index taken
out, and a stacked rule's spec loses its leading (never sharded) layer
entry.

How a leaf is sharded.  JAX shards one DIM of a leaf over fsdp and lets
XLA gather it on use.  The port shards the leaf FLAT: each fsdp rank owns
a contiguous range of whole 2048-element blocks (train/optimizer.BLOCK) of
the row-major flat tensor, ceil(blocks / fsdp) of them, the tail padded
with whole zero blocks (as ZeRO pads); parallel/fsdp.py gathers them
back.  Whole blocks are what keeps the int8 Adam moments the single-process
port's: their scales are per 2048-block of the flat tensor, so a shard
that cut a block would change every update.  The rules therefore decide
only WHETHER a leaf is sharded (its spec names "fsdp") or replicated (JAX's
P() leaves: the final norm, the merger, the projector).  One more leaf
stays replicated: a per-layer tensor whose size is not a multiple of 2048
(norm scales, biases), because the optimizer keeps ONE moment state for
all layers' copies of it (JAX's stacked leaf cut into blocks) and a shard
would split that group.

Tensor parallelism.  Each rule's "tp" entry names the dim a leaf splits
over the tp axis (column, row or vocab: parallel/tp.py).  A family's tp
plan (`TPPlan`, QWEN_TP_LEAVES for the Qwen families) says which of those
leaves are stored split: the rank at tp index t keeps part t of that dim
(parallel/tp.Split), cut head-aware for the ViT's fused qkv kernel (its
3 * heads * head_dim columns split per q, k and v: heads [t * H / tp,
(t + 1) * H / tp) of each) and per half for Aria's experts' fc1 (its
[projection, gate] columns: each rank keeps columns [t * I / tp, (t + 1)
* I / tp) of each half; JAX cuts 2I contiguously and lets GSPMD reshard
around the split), and shards that slice over fsdp in whole
2048-element blocks as above.  Every leaf the plan splits is an fsdp Shard
at the 7B geometry.  The others stay whole on every tp rank, and the model
takes their slice where it uses them (parallel/tp.local, whose gradient
is all-gathered back to the whole leaf): the column-parallel biases (q/k/v,
the ViT's qkv, gate/up and fc1, the merger's mlp_0), the row-parallel
biases (added after the all-reduce, unsplit), `visual/patch_embed/proj`
(1176 x 1280: a split would only add an all-gather) and a planned kernel
that stays whole over fsdp (a per-layer tensor whose size is not a
multiple of 2048, as the tiny configs' ViT qkv and proj).  A tp that does
not divide the LM's heads, its KV heads, the ViT's heads or a split dim
raises ValueError at `shard_params`, naming it.

Expert parallelism.  A family's plan may name leaves placed by expert
(Aria's experts under moe_impl "ep": `TPPlan.experts`): they become Shards
whose blocks are split over the plan's ep axes (`TPPlan.ep_axes`, from
cfg.moe_ep_axis: fsdp, data or data x fsdp) instead of fsdp, exactly their
rank's experts (parallel/expert.py says why and raises where the ep group
does not cut them into whole experts of whole blocks); they are never
gathered.

Batches: row-indexed arrays split their batch dim over data x fsdp, each
rank taking a contiguous range in row-major rank order (JAX's P(("data",
"fsdp"))); packed vision inputs replicate, and a dim that does not divide
falls back to replication, as JAX's place_batch does.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Sequence

import numpy as np
import torch

# copied from spacer_tpu/parallel/partition.py (PartitionSpecs as tuples)
_QUANT_MOMENT_RULES: list = [
    (r"\.(mu|nu)_q/", ("fsdp", None)),
    (r"\.(mu|nu)_s/", ("fsdp", None)),
]

QWEN_PARTITION_RULES: list = _QUANT_MOMENT_RULES + [
    # LM stacked layers: kernels (L, in, out)
    (r"model/layers/self_attn/(q|k|v)_proj/kernel", (None, "fsdp", "tp")),
    (r"model/layers/self_attn/o_proj/kernel", (None, "tp", "fsdp")),
    (r"model/layers/self_attn/(q|k|v)_proj/bias", (None, "tp")),
    (r"model/layers/mlp/(gate|up)_proj/kernel", (None, "fsdp", "tp")),
    (r"model/layers/mlp/down_proj/kernel", (None, "tp", "fsdp")),
    (r"model/layers/.*layernorm/scale", (None, None)),
    # embeddings / head
    (r"model/embed_tokens/embedding", ("tp", "fsdp")),
    (r"model/lm_head/kernel", ("fsdp", "tp")),
    (r"model/norm/scale", ()),
    # ViT stacked blocks
    (r"visual/blocks/attn/qkv/kernel", (None, "fsdp", "tp")),
    (r"visual/blocks/attn/qkv/bias", (None, "tp")),
    (r"visual/blocks/attn/proj/kernel", (None, "tp", "fsdp")),
    (r"visual/blocks/attn/proj/bias", (None, None)),
    (r"visual/blocks/mlp/(gate|up)_proj/kernel", (None, "fsdp", "tp")),
    (r"visual/blocks/mlp/(gate|up)_proj/bias", (None, "tp")),
    (r"visual/blocks/mlp/down_proj/kernel", (None, "tp", "fsdp")),
    (r"visual/blocks/mlp/down_proj/bias", (None, None)),
    # Qwen2-VL ViT MLP (fc1/quick_gelu/fc2)
    (r"visual/blocks/mlp/fc1/kernel", (None, "fsdp", "tp")),
    (r"visual/blocks/mlp/fc1/bias", (None, "tp")),
    (r"visual/blocks/mlp/fc2/kernel", (None, "tp", "fsdp")),
    (r"visual/blocks/mlp/fc2/bias", (None, None)),
    (r"visual/blocks/norm[12]/scale", (None, None)),
    (r"visual/patch_embed/proj/kernel", ("fsdp", "tp")),
    (r"visual/merger/mlp_0/kernel", ("fsdp", "tp")),
    (r"visual/merger/mlp_0/bias", ("tp",)),
    (r"visual/merger/mlp_2/kernel", ("tp", "fsdp")),
    (r"visual/merger/.*", ()),
    # fallback: replicate
    (r".*", ()),
]

ARIA_PARTITION_RULES: list = _QUANT_MOMENT_RULES + [
    # MoE: router replicated (tiny), experts (L, E, in, out)
    (r"model/layers/mlp/router/kernel", (None, None, None)),
    (r"model/layers/mlp/experts/fc1/kernel", (None, "fsdp", None, "tp")),
    (r"model/layers/mlp/experts/fc2/kernel", (None, "fsdp", "tp", None)),
    (r"model/layers/mlp/shared/(gate|up)_proj/kernel", (None, "fsdp", "tp")),
    (r"model/layers/mlp/shared/down_proj/kernel", (None, "tp", "fsdp")),
    # LM attention / norms / embeddings: same geometry as Qwen
    (r"model/layers/self_attn/(q|k|v)_proj/kernel", (None, "fsdp", "tp")),
    (r"model/layers/self_attn/o_proj/kernel", (None, "tp", "fsdp")),
    (r"model/layers/self_attn/(q|k|v)_proj/bias", (None, "tp")),
    (r"model/layers/.*layernorm/scale", (None, None)),
    (r"model/embed_tokens/embedding", ("tp", "fsdp")),
    (r"model/lm_head/kernel", ("fsdp", "tp")),
    (r"model/norm/scale", ()),
    # Idefics3/SigLIP tower: stacked (L, in, out) kernels
    (r"visual/encoder/self_attn/(q|k|v)_proj/kernel", (None, "fsdp", "tp")),
    (r"visual/encoder/self_attn/(q|k|v)_proj/bias", (None, "tp")),
    (r"visual/encoder/self_attn/out_proj/kernel", (None, "tp", "fsdp")),
    (r"visual/encoder/mlp/fc1/kernel", (None, "fsdp", "tp")),
    (r"visual/encoder/mlp/fc1/bias", (None, "tp")),
    (r"visual/encoder/mlp/fc2/kernel", (None, "tp", "fsdp")),
    (r"visual/embeddings/patch_embedding/kernel", ("fsdp", "tp")),
    (r"visual/embeddings/position_embedding/embedding", (None, "fsdp")),
    # projector: small, replicate
    (r"projector/.*", ()),
    # fallback: replicate
    (r".*", ()),
]

# the leaves a Qwen model stores split over tp (the others, tp-ruled or not,
# stay whole on every tp rank: see the module docstring); "qkv" splits
# head-aware
QWEN_TP_LEAVES: list = [
    (r"model/layers/self_attn/(q|k|v|o)_proj/kernel", "split"),
    (r"model/layers/mlp/(gate|up|down)_proj/kernel", "split"),
    (r"model/embed_tokens/embedding", "split"),
    (r"model/lm_head/kernel", "split"),
    (r"visual/blocks/attn/qkv/kernel", "qkv"),
    (r"visual/blocks/attn/proj/kernel", "split"),
    (r"visual/blocks/mlp/(gate|up|down)_proj/kernel", "split"),
    (r"visual/blocks/mlp/fc[12]/kernel", "split"),
    (r"visual/merger/mlp_[02]/kernel", "split"),
]


# the leaves an Aria model stores split over tp; "halves" splits the
# experts' fc1 (E, D, 2I) per [projection, gate] half (each rank keeps its
# columns of both); the router, the norms, the tower's embeddings and the
# projector stay whole
ARIA_TP_LEAVES: list = [
    (r"model/layers/self_attn/(q|k|v|o)_proj/kernel", "split"),
    (r"model/layers/mlp/shared/(gate|up|down)_proj/kernel", "split"),
    (r"model/layers/mlp/experts/fc1/kernel", "halves"),
    (r"model/layers/mlp/experts/fc2/kernel", "split"),
    (r"model/embed_tokens/embedding", "split"),
    (r"model/lm_head/kernel", "split"),
    (r"visual/encoder/self_attn/(q|k|v|out)_proj/kernel", "split"),
    (r"visual/encoder/mlp/fc[12]/kernel", "split"),
]

# the expert leaves moe_impl "ep" places by expert over fsdp
ARIA_EXPERT_LEAVES = r"model/layers/mlp/experts/fc[12]/kernel"


class TPPlan(NamedTuple):
    """A family's tensor-parallel plan for one config: the leaves stored
    split ([(regex, "split" | "qkv" | "halves")]), the counts tp must
    divide ({name: count}), the head_dim of a "qkv" split, the regex of
    the leaves placed by expert (moe_impl "ep"; parallel/expert.py) and the
    ep axes they are placed over."""

    leaves: list
    heads: dict
    qkv_head_dim: int = 1
    experts: str | None = None
    ep_axes: tuple = ("fsdp",)

    def kind(self, path: str):
        jax_path, _ = _unstacked(path)
        for pattern, kind in self.leaves:
            if re.fullmatch(pattern, jax_path):
                return kind
        return None

    def check(self, tp: int) -> "TPPlan":
        """ValueError naming a count tp does not divide."""
        for what, n in self.heads.items():
            if n % tp:
                raise ValueError(f"tp={tp} does not divide {what}={n}")
        return self

    def placed(self, path: str) -> bool:
        return self.experts is not None and bool(
            re.fullmatch(self.experts, _unstacked(path)[0]))


def qwen_tp_plan(cfg) -> TPPlan:
    return TPPlan(QWEN_TP_LEAVES,
                  {"the LM's num_heads": cfg.text.num_heads,
                   "the LM's num_kv_heads": cfg.text.num_kv_heads,
                   "the ViT's num_heads": cfg.vision.num_heads},
                  cfg.vision.head_dim)


def aria_tp_plan(cfg) -> TPPlan:
    """Aria's plan: tp must divide the LM's heads and KV heads, the tower's
    heads, the expert intermediate and the shared experts' width; under
    moe_impl "ep" the experts are placed by expert over cfg.moe_ep_axis
    (ValueError for an axis expert.ep_axes does not take)."""
    from spacer_tpu_torch.parallel.expert import ep_axes

    t = cfg.text
    return TPPlan(ARIA_TP_LEAVES,
                  {"the LM's num_heads": t.num_heads,
                   "the LM's num_kv_heads": t.num_kv_heads,
                   "the tower's num_heads": cfg.vision.num_heads,
                   "the expert intermediate_size": t.intermediate_size,
                   "the shared experts' width":
                   t.intermediate_size * t.moe_num_shared_experts},
                  experts=ARIA_EXPERT_LEAVES if t.moe_impl == "ep" else None,
                  ep_axes=ep_axes(t.moe_ep_axis) if t.moe_impl == "ep"
                  else ("fsdp",))


# the port's per-layer list containers (JAX's stacked leaves)
_STACKED = ("layers", "blocks", "encoder")


def _unstacked(path: str):
    """'model/layers/3/mlp/x' -> ('model/layers/mlp/x', True); a path
    outside the layer lists -> (path, False)."""
    parts = path.split("/")
    for i in range(len(parts) - 1):
        if parts[i] in _STACKED and parts[i + 1].isdigit():
            return "/".join(parts[:i + 1] + parts[i + 2:]), True
    return path, False


def spec_for(path: str, ndim: int, rules) -> tuple:
    """The spec of one port leaf: the first rule matching its path with
    the layer index taken out, minus the stacked layer axis, trimmed to the
    leaf's rank."""
    jax_path, stacked = _unstacked(path)
    for pattern, spec in rules:
        if re.fullmatch(pattern, jax_path) or re.search(pattern, jax_path):
            spec = tuple(spec)
            if stacked and spec:
                spec = spec[1:]
            return spec[:ndim]
    return ()


# params trees nest dicts and lists; a spec (a tuple) is a leaf
def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _map_named(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def partition_spec_tree(params, rules: Sequence | None = None):
    """Tree of specs matching `params`' structure."""
    rules = rules if rules is not None else QWEN_PARTITION_RULES
    return _map_named(lambda p, t: spec_for(p, t.dim(), rules), params)


def fsdp_sharded(path: str, leaf, spec) -> bool:
    """Whether a leaf is sharded over fsdp (see the module docstring)."""
    from spacer_tpu_torch.train.optimizer import BLOCK

    if "fsdp" not in spec:
        return False
    return not (_unstacked(path)[1] and leaf.numel() % BLOCK)


def tp_split(path: str, leaf, spec, mesh, plan: TPPlan | None):
    """The parallel.tp.Split of a leaf the plan stores split (its spec's
    "tp" dim), or None for a leaf whole on every tp rank (and at tp 1)."""
    from spacer_tpu_torch.parallel.tp import Split

    tp = mesh.shape["tp"]
    if tp == 1 or plan is None or "tp" not in spec:
        return None
    kind = plan.kind(path)
    if kind is None or not fsdp_sharded(path, leaf, spec):
        return None
    pre, post = {"qkv": (3, plan.qkv_head_dim),
                 "halves": (2, 1)}.get(kind, (1, 1))
    return Split.make(leaf.shape, spec.index("tp"), tp, mesh.coords["tp"],
                      pre, post, what=path)


def shard_params(params, mesh, rules=None, tp_plan: TPPlan | None = None):
    """Full params (the same on every rank) -> (this rank's params, specs):
    the fsdp-sharded leaves become parallel.fsdp.Shard (this rank's whole
    blocks of its tp slice where `tp_plan` splits the leaf), the others
    stay as they are (replicated).  Makes `mesh` (one built by
    create_mesh) the active one of parallel/tp.py.  At tp > 1 a plan is
    required, and a tp that does not divide its head counts or a split dim
    raises ValueError.  The leaves the plan places by expert become
    expert-placed Shards over the plan's ep axes (parallel/expert.py;
    ValueError where the ep group does not cut them into whole experts)."""
    from spacer_tpu_torch.parallel import tp as tpmod
    from spacer_tpu_torch.parallel.expert import check_placement
    from spacer_tpu_torch.parallel.fsdp import Shard

    tp = mesh.shape["tp"]
    if tp > 1:
        if tp_plan is None:
            raise ValueError(f"tp={tp} needs the model family's tp plan "
                             "(ModelFamily.tp_plan)")
        tp_plan.check(tp)
    specs = partition_spec_tree(params, rules)
    spec_of = dict(_named_leaves(specs))

    def place(path, leaf):
        if isinstance(leaf, Shard):
            raise ValueError(f"{path} is already sharded")
        spec = spec_of[path]
        placed = tp_plan is not None and tp_plan.placed(path)
        if fsdp_sharded(path, leaf, spec):
            shard = Shard.from_full(leaf, mesh,
                                    tp_split(path, leaf, spec, mesh, tp_plan),
                                    experts=tp_plan.ep_axes if placed else ())
            if placed:
                check_placement(shard)
            return shard
        if placed:
            raise ValueError(f"{path} ({tuple(leaf.shape)}) is not whole "
                             "2048-blocks: moe_impl='ep' cannot place it")
        return leaf

    placed = _map_named(place, params)
    if mesh.groups:     # a mesh over a process group (not a placement test's)
        tpmod.set_mesh(mesh)
    return placed, specs


def batch_spec(mesh) -> tuple:
    """Batch-dimension spec: data-parallel over data x fsdp."""
    return (("data", "fsdp"),)


# batch keys whose SECOND dim is the batch dimension (e.g. rope position_ids
# are (3, N, S)); everything else shards dim 0.
_BATCH_DIM1_KEYS = frozenset(
    {"position_ids", "prompt_position_ids", "completion_position_ids"}
)
# keys shared by the whole batch (packed patch/crop tokens, not per-row)
_REPLICATED_KEYS = frozenset(
    {"pixel_values", "patch_mask", "pixel_position_ids"}
)


def row_range(n: int, mesh) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of a batch dim of n rows: its
    contiguous share over data x fsdp, or all rows where n does not divide
    (or with no mesh)."""
    if mesh is None:
        return 0, n
    shards = mesh.shape["data"] * mesh.shape["fsdp"]
    if n % shards:
        return 0, n
    per = n // shards
    return mesh.batch_index * per, (mesh.batch_index + 1) * per


def batch_dim(key: str) -> int:
    return 1 if key in _BATCH_DIM1_KEYS else 0


def place_batch(batch: dict, mesh):
    """A global batch (the same on every rank) -> this rank's rows of it.

    Row-indexed arrays (numpy or tensors) keep this rank's range of their
    batch dim (`row_range`); packed vision inputs, scalars and dims that
    do not divide stay whole (replicated).  Other values (grids, python
    lists) pass through."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)) or k in _REPLICATED_KEYS:
            out[k] = v
            continue
        dim = batch_dim(k)
        if v.ndim <= dim:
            out[k] = v
            continue
        lo, hi = row_range(v.shape[dim], mesh)
        index = (slice(None),) * dim + (slice(lo, hi),)
        out[k] = v[index]
    return out
