"""Edge-partitioned graph parallelism (counterpart of the graph-axis part
of ``graphphysics_tpu/parallel``): ``P`` ranks of one graph process group
(``mesh``), one part of the partitioned graph each (``graph_partition``,
``reorder``), the train step, forward and rollout over them (``dp``)."""

from graphphysics_torch.parallel.dp import (
    gather_rows,
    graph_parallel_forward,
    make_graph_parallel_train_step,
    merge_normalizer_states,
    partitioned_rollout,
)
from graphphysics_torch.parallel.graph_partition import (
    halo_requests,
    part_of,
    partition_frames_np,
    partition_graph_halo_np,
    partition_graph_np,
    unpartition_rows,
)
from graphphysics_torch.parallel.mesh import (
    GRAPH_AXIS,
    backend_for,
    graph_group,
    graph_rank,
    graph_size,
    init_from_env,
    init_graph_group,
    launch,
)
from graphphysics_torch.parallel.reorder import (
    halo_volume,
    inverse_permutation,
    locality_permutation,
    permute_graph_np,
)

__all__ = [
    "GRAPH_AXIS",
    "backend_for",
    "gather_rows",
    "graph_group",
    "graph_parallel_forward",
    "graph_rank",
    "graph_size",
    "halo_requests",
    "halo_volume",
    "init_from_env",
    "init_graph_group",
    "inverse_permutation",
    "launch",
    "locality_permutation",
    "make_graph_parallel_train_step",
    "merge_normalizer_states",
    "part_of",
    "partition_frames_np",
    "partition_graph_halo_np",
    "partition_graph_np",
    "partitioned_rollout",
    "permute_graph_np",
    "unpartition_rows",
]
