"""Data, graph, tensor and pipeline parallelism (counterpart of
``graphphysics_tpu/parallel``): the process groups of the data, graph,
model and pipe axes and their layouts, hybrid ones too (``mesh``), the
data-parallel, graph-parallel and 2-D train steps, the partitioned forward
and rollout (``dp``), the tensor-parallel step (``tp``), the GPipe step
(``pp``), the parts of a partitioned graph (``graph_partition``,
``reorder``) and the ranks' loader and shares (``multihost``)."""

from graphphysics_torch.parallel.dp import (
    gather_rows,
    graph_parallel_forward,
    make_dp_graph_parallel_train_step,
    make_dp_train_step,
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
    DATA_AXIS,
    GRAPH_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Layout,
    axis_group,
    backend_for,
    data_rank,
    data_size,
    graph_group,
    graph_rank,
    graph_size,
    init_from_env,
    init_graph_group,
    init_layout,
    launch,
    make_hybrid_layout,
    make_layout,
)
from graphphysics_torch.parallel.multihost import (
    MultihostGraphLoader,
    global_batch_from_local,
    initialize_distributed,
    process_local_indices,
)
from graphphysics_torch.parallel.pp import (
    gather_pp_state_dict,
    make_pp_train_step,
    shard_pp_state,
)
from graphphysics_torch.parallel.tp import (
    gather_tp_state_dict,
    make_tp_train_step,
    shard_tp_state,
    tp_param_specs,
)
from graphphysics_torch.parallel.reorder import (
    halo_volume,
    inverse_permutation,
    locality_permutation,
    permute_graph_np,
)

__all__ = [
    "DATA_AXIS",
    "GRAPH_AXIS",
    "Layout",
    "MODEL_AXIS",
    "MultihostGraphLoader",
    "PIPE_AXIS",
    "axis_group",
    "backend_for",
    "data_rank",
    "data_size",
    "gather_pp_state_dict",
    "gather_rows",
    "gather_tp_state_dict",
    "global_batch_from_local",
    "graph_group",
    "graph_parallel_forward",
    "graph_rank",
    "graph_size",
    "halo_requests",
    "halo_volume",
    "init_from_env",
    "init_graph_group",
    "init_layout",
    "initialize_distributed",
    "inverse_permutation",
    "launch",
    "locality_permutation",
    "make_dp_graph_parallel_train_step",
    "make_dp_train_step",
    "make_graph_parallel_train_step",
    "make_hybrid_layout",
    "make_layout",
    "make_pp_train_step",
    "make_tp_train_step",
    "merge_normalizer_states",
    "part_of",
    "partition_frames_np",
    "partition_graph_halo_np",
    "partition_graph_np",
    "partitioned_rollout",
    "permute_graph_np",
    "process_local_indices",
    "shard_pp_state",
    "shard_tp_state",
    "tp_param_specs",
    "unpartition_rows",
]
