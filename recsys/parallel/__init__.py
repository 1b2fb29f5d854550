from recsys.parallel.mesh import (  # noqa: F401
    build_mesh,
    data_sharding,
    replicated,
    row_sharding,
    shard_batch,
)
