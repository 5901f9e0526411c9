from graphphysics_torch.core.device import resolve_device
from graphphysics_torch.core.graph import (
    Graph,
    bucket_size,
    concat_graphs,
    flatten_batched_graph,
    masked_filler,
    pad_graph_csr_np,
    pad_graph_ell_np,
    pad_graph_np,
    pad_graph_sorted_np,
    round_up,
    stack_graphs,
)
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.core import normalizer

__all__ = [
    "Graph",
    "NodeType",
    "bucket_size",
    "concat_graphs",
    "flatten_batched_graph",
    "masked_filler",
    "pad_graph_csr_np",
    "pad_graph_ell_np",
    "pad_graph_np",
    "pad_graph_sorted_np",
    "resolve_device",
    "round_up",
    "stack_graphs",
    "normalizer",
]
