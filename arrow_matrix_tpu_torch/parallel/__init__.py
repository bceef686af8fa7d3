from arrow_matrix_tpu_torch.parallel.mesh import (
    Mesh,
    fetch_replicated,
    initialize_multihost,
    largest_replication,
    make_hybrid_mesh,
    make_mesh,
    make_repl_mesh,
    shard_blocked,
)
from arrow_matrix_tpu_torch.parallel.multi_level import (
    MultiLevelArrow,
    compose_routing,
    multi_level_spmm,
    pad_permutation,
    requantize,
    resolve_feature_dtype,
)
from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel, SellSlim
from arrow_matrix_tpu_torch.parallel.sell_space import SellSpaceShared
from arrow_matrix_tpu_torch.parallel.spmm_1d import (
    MatrixSlice1D,
    equal_slices,
)
from arrow_matrix_tpu_torch.parallel.spmm_15d import SpMM15D
from arrow_matrix_tpu_torch.parallel.space_shared import (
    SpaceSharedArrow,
    space_shared_spmm,
    stack_arrow_blocks,
)

__all__ = [
    "MatrixSlice1D",
    "Mesh",
    "MultiLevelArrow",
    "SellMultiLevel",
    "SellSlim",
    "SellSpaceShared",
    "SpMM15D",
    "SpaceSharedArrow",
    "compose_routing",
    "equal_slices",
    "fetch_replicated",
    "initialize_multihost",
    "largest_replication",
    "make_hybrid_mesh",
    "make_mesh",
    "make_repl_mesh",
    "multi_level_spmm",
    "pad_permutation",
    "requantize",
    "resolve_feature_dtype",
    "shard_blocked",
    "space_shared_spmm",
    "stack_arrow_blocks",
]
