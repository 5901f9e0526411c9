from graphphysics_torch.ops.csr_segment import (
    compute_row_bounds,
    csr_segment_sum,
    csr_segment_sum_reference,
)
from graphphysics_torch.ops.segment import masked_segment_sum, take_rows

__all__ = [
    "compute_row_bounds",
    "csr_segment_sum",
    "csr_segment_sum_reference",
    "masked_segment_sum",
    "take_rows",
]
