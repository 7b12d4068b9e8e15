"""Parallelism over torch.distributed (counterpart of spacer_tpu/parallel/):
the (data, fsdp, tp) mesh (mesh.py), process-group setup and host-side
exchanges (multihost.py), the partition rules and batch placement
(partition.py), the fsdp Shards with their gather and reduce-scatter
(fsdp.py), tensor parallelism's conjugate operations (tp.py), expert
parallelism over the fsdp axis (expert.py) and the host offload of
optimizer state (offload.py).  The pipeline and ring attention are not
ported (ROADMAP queue A items 2b.3 and 2b.4)."""

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
