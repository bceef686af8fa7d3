from arrow_matrix_tpu_torch.decomposition.decompose import (
    ArrowLevel,
    achieved_width,
    arrow_decomposition,
    decomposition_spmm,
    reconstruct,
)
from arrow_matrix_tpu_torch.decomposition.linearize import (
    bfs_order,
    random_forest_order,
)
from arrow_matrix_tpu_torch.decomposition import native

__all__ = [
    "ArrowLevel",
    "achieved_width",
    "arrow_decomposition",
    "bfs_order",
    "decomposition_spmm",
    "native",
    "random_forest_order",
    "reconstruct",
]
