"""The port's parallel runtime over ``torch.distributed`` (the JAX
package's ``parallel/``): a ("data", "space") mesh of ranks, batch sharding
and replication, halo exchange for spatially sharded inference,
data-parallel serving and the multi-rank dry run."""

from .mesh import create_mesh, local_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    batch_sharding,
    replicated,
    shard_batch,
    shard_params,
)
