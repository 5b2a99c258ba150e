from .mesh import (Mesh, barrier, gather_rows,  # noqa: F401
                   init_distributed, make_mesh, on_rank0, replicate,
                   shard_batch)
