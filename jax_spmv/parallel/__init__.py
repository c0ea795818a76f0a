from .distributed import (
    ShardedCSR,
    init_distributed,
    make_row_mesh,
    pagerank_sharded,
    pagerank_step_sharded,
    shard_csr,
    spmv_csr_sharded,
)

__all__ = [
    "ShardedCSR",
    "init_distributed",
    "make_row_mesh",
    "pagerank_sharded",
    "pagerank_step_sharded",
    "shard_csr",
    "spmv_csr_sharded",
]
