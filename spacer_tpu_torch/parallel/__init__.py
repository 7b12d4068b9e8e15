"""Host offload of optimizer state (counterpart of spacer_tpu/parallel/,
which also holds the mesh, sharding and multihost code the port has not
ported)."""

from spacer_tpu_torch.parallel.offload import (  # noqa: F401
    is_on_host,
    offload_to_host,
    to_device,
)
