from arrow_matrix_tpu_torch.utils.device import card_report, resolve_device
from arrow_matrix_tpu_torch.utils.graphs import (
    barabasi_albert,
    random_dense,
    symmetrize,
)
from arrow_matrix_tpu_torch.utils.numerics import (
    bf16_within_one_ulp,
    relative_error,
    relative_tolerance,
)

__all__ = [
    "barabasi_albert",
    "bf16_within_one_ulp",
    "card_report",
    "random_dense",
    "relative_error",
    "relative_tolerance",
    "resolve_device",
    "symmetrize",
]
