"""Parallelism over torch.distributed (counterpart of spacer_tpu/parallel/):
the (data, fsdp, tp) mesh (mesh.py), process-group setup and host-side
exchanges (multihost.py), the partition rules and batch placement
(partition.py), the fsdp Shards with their gather and reduce-scatter
(fsdp.py), tensor parallelism's conjugate operations (tp.py), expert
parallelism over the fsdp axis (expert.py), pipeline parallelism over a
pipe axis (pipeline.py: GPipe with its send / recv as autograd
operations) and the host offload of optimizer state (offload.py).  Ring
attention, sequence parallelism over a mesh axis, is
spacer_tpu_torch/ops/ring_attention.py, as in the JAX package."""

from spacer_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    Mesh,
    create_mesh,
    mesh_shape_for,
)
from spacer_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_lm_forward,
    pipeline_param_spec,
    shard_layers_for_pipeline,
)
from spacer_tpu_torch.parallel.offload import (  # noqa: F401
    is_on_host,
    offload_to_host,
    to_device,
)
from spacer_tpu_torch.parallel.partition import (  # noqa: F401
    ARIA_PARTITION_RULES,
    QWEN_PARTITION_RULES,
    batch_spec,
    partition_spec_tree,
    place_batch,
    shard_params,
)
