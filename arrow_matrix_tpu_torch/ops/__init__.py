from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    ArrowBlocks,
    arrow_blocks_from_csr,
    arrow_blocks_streamed,
    arrow_spmm,
    block_features,
    block_row_stats,
    resolve_block_dtype,
    unblock_features,
)
from arrow_matrix_tpu_torch.ops.cuda_blocks import arrow_spmm_cuda
from arrow_matrix_tpu_torch.ops.cuda_ell import (
    arrow_spmm_ell_cuda,
    hyb_spmm_cuda,
)
from arrow_matrix_tpu_torch.ops.cuda_gather import (
    granule_gather,
    row_gather,
    row_gather_add_,
)
from arrow_matrix_tpu_torch.ops.cuda_sell import (
    quantize_features,
    sell_spmm_cuda,
    sell_tier_spmm,
)
from arrow_matrix_tpu_torch.ops.ell import (
    SLOT_ALIGN,
    align_up,
    dense_pack_stack,
    dense_spmm_batched,
    ell_pack,
    ell_pack_stack,
    ell_spmm,
    ell_spmm_batched,
    ell_tier_spmm,
)
from arrow_matrix_tpu_torch.ops.gather import (
    granule_gather_plain,
    pack_granules,
    row_gather_add_plain,
    row_gather_plain,
    take,
)
from arrow_matrix_tpu_torch.ops.hyb import HybLevel, hyb_from_csr, hyb_spmm
from arrow_matrix_tpu_torch.ops.sell import (
    SellMatrix,
    resolve_binary,
    sell_from_arrays,
    sell_from_csr,
    sell_spmm,
    sell_spmm_t,
    sell_stats,
    tier_boundaries,
)

__all__ = [
    "ArrowBlocks",
    "HybLevel",
    "SLOT_ALIGN",
    "SellMatrix",
    "align_up",
    "arrow_blocks_from_csr",
    "arrow_blocks_streamed",
    "arrow_spmm",
    "arrow_spmm_cuda",
    "arrow_spmm_ell_cuda",
    "block_features",
    "block_row_stats",
    "dense_pack_stack",
    "dense_spmm_batched",
    "ell_pack",
    "ell_pack_stack",
    "ell_spmm",
    "ell_spmm_batched",
    "ell_tier_spmm",
    "granule_gather",
    "granule_gather_plain",
    "hyb_from_csr",
    "hyb_spmm",
    "hyb_spmm_cuda",
    "pack_granules",
    "quantize_features",
    "resolve_binary",
    "resolve_block_dtype",
    "row_gather",
    "row_gather_add_",
    "row_gather_add_plain",
    "row_gather_plain",
    "sell_from_arrays",
    "sell_from_csr",
    "sell_spmm",
    "sell_spmm_cuda",
    "sell_spmm_t",
    "sell_stats",
    "sell_tier_spmm",
    "take",
    "tier_boundaries",
    "unblock_features",
]
