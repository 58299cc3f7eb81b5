from .mesh import AXES, make_mesh, maybe_init_distributed  # noqa: F401
from .sharding import (  # noqa: F401
    batch_spec,
    param_specs,
    shard_params,
)
