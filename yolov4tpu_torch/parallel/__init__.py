from .mesh import (Mesh, init_distributed, make_mesh, on_rank0,  # noqa: F401
                   replicate, shard_batch)
