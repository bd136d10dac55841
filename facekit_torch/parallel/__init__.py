from facekit_torch.parallel.mesh import Mesh, canonical, make_mesh  # noqa: F401
from facekit_torch.parallel.placement import (  # noqa: F401
    Replicated,
    Sharding,
    device_put,
    gather,
    sharding_of,
)
from facekit_torch.parallel.sharded_search import (  # noqa: F401
    ShardedRows,
    search_positions,
    shard_gallery,
    shard_rows,
    sharded_cosine_topk,
)
