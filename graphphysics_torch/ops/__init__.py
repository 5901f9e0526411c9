from graphphysics_torch.ops.attention import sparse_graph_attention
from graphphysics_torch.ops.csr_attention import (
    csr_softmax_spmm,
    csr_softmax_spmm_backward,
    csr_softmax_spmm_backward_reference,
    csr_softmax_spmm_pair,
    csr_softmax_spmm_pair_backward,
    csr_softmax_spmm_pair_backward_reference,
    csr_softmax_spmm_pair_reference,
    csr_softmax_spmm_reference,
    csr_sparse_attention,
)
from graphphysics_torch.ops.csr_segment import (
    compute_row_bounds,
    csr_segment_sum,
    csr_segment_sum_backward,
    csr_segment_sum_backward_reference,
    csr_segment_sum_reference,
)
from graphphysics_torch.ops.ell_ops import ell_gather, ell_repeat, ell_segment_sum, ell_softmax
from graphphysics_torch.ops.segment import masked_segment_sum, segment_softmax, take_rows

__all__ = [
    "compute_row_bounds",
    "csr_segment_sum",
    "csr_segment_sum_backward",
    "csr_segment_sum_backward_reference",
    "csr_segment_sum_reference",
    "csr_softmax_spmm",
    "csr_softmax_spmm_backward",
    "csr_softmax_spmm_backward_reference",
    "csr_softmax_spmm_pair",
    "csr_softmax_spmm_pair_backward",
    "csr_softmax_spmm_pair_backward_reference",
    "csr_softmax_spmm_pair_reference",
    "csr_softmax_spmm_reference",
    "csr_sparse_attention",
    "ell_gather",
    "ell_repeat",
    "ell_segment_sum",
    "ell_softmax",
    "masked_segment_sum",
    "segment_softmax",
    "sparse_graph_attention",
    "take_rows",
]
