from arrow_matrix_tpu_torch.utils.device import card_report, resolve_device
from arrow_matrix_tpu_torch.utils.graphs import (
    barabasi_albert,
    erdos_renyi,
    grid_graph,
    random_csr,
    random_dense,
    symmetrize,
)
from arrow_matrix_tpu_torch.utils.logging import (
    SegmentLog,
    finish,
    get_log,
    log,
    set_iteration_data,
)
from arrow_matrix_tpu_torch.utils.numerics import (
    bf16_within_one_ulp,
    relative_error,
    relative_tolerance,
)

__all__ = [
    "SegmentLog",
    "barabasi_albert",
    "bf16_within_one_ulp",
    "card_report",
    "erdos_renyi",
    "finish",
    "get_log",
    "grid_graph",
    "log",
    "random_csr",
    "random_dense",
    "relative_error",
    "relative_tolerance",
    "resolve_device",
    "set_iteration_data",
    "symmetrize",
]
