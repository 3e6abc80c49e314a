from xitorch_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, shard_batch, with_batch_sharding, P, Mesh, NamedSharding,
)
