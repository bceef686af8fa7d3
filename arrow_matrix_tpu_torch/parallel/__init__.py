from arrow_matrix_tpu_torch.parallel.multi_level import (
    MultiLevelArrow,
    compose_routing,
    multi_level_spmm,
    pad_permutation,
    requantize,
    resolve_feature_dtype,
)

__all__ = [
    "MultiLevelArrow",
    "compose_routing",
    "multi_level_spmm",
    "pad_permutation",
    "requantize",
    "resolve_feature_dtype",
]
