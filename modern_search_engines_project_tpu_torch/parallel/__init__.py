from modern_search_engines_project_tpu_torch.parallel.multihost import (
    init_multihost,
    make_multihost_mesh,
)
from modern_search_engines_project_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedDeviceIndex,
    ShardedEngineBackend,
    make_mesh,
)

__all__ = [
    "Mesh",
    "ShardedDeviceIndex",
    "ShardedEngineBackend",
    "make_mesh",
    "init_multihost",
    "make_multihost_mesh",
]
