"""Parallelism over torch.distributed (counterpart of spacer_tpu/parallel/):
the (data, fsdp, tp) mesh (mesh.py), process-group setup and host-side
exchanges (multihost.py), the partition rules and batch placement
(partition.py), the fsdp Shards with their gather and reduce-scatter
(fsdp.py), tensor parallelism's conjugate operations (tp.py) and the host
offload of optimizer state (offload.py).  The pipeline, ring attention
and Aria under tp are not ported (ROADMAP queue A item 2b)."""

from spacer_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    Mesh,
    create_mesh,
    mesh_shape_for,
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
