"""Shared helpers of the ``test_torch_port_*`` files: weights carried from
flax to the port through ``export_reference_state_dict`` and one simulator
configuration built on both sides.

Importing this module caps torch's intra-op threads: the test workers also
run XLA, and torch's default of one thread per core oversubscribes a small
machine when several workers run at once. Every port test file imports it.

It also turns JAX's asynchronous CPU dispatch off for the process. With it
on, an eager call of a Pallas kernel in TPU interpret mode (the port tests'
references, and the JAX package's own tests) can deadlock: the kernel's
``io_callback`` dispatches jnp ops from the runtime's thread while the main
thread dispatches the next op, and neither returns. On an 8-core CPU, six
processes that each ran ``EncodeTransformDecode.apply`` on a CSR graph 40
times in interpret mode all hung within 9 calls with it on, and all
finished with it off. The flag is read when the CPU client is made, so it
has to be set before the first array: pytest imports every test module
before it runs a test, and no module before the first port file makes one.
Synchronous dispatch computes the same values."""

import jax
import numpy as np
import torch

from graphphysics_torch.core.graph import concat_graphs, pad_graph_sorted_np
from graphphysics_tpu.utils.torch_import import export_reference_state_dict

TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)
jax.config.update("jax_cpu_enable_async_dispatch", False)


def state_dict_under(prefix: str, model_params) -> dict:
    """The port state_dict of one submodule: export ``{"model": params}`` in
    the reference layout and keep the keys under ``model.<prefix>.``."""
    exported = export_reference_state_dict({"model": model_params})
    head = f"model.{prefix}."
    return {
        k[len(head):]: torch.from_numpy(np.array(v, np.float32))
        for k, v in exported.items()
        if k.startswith(head)
    }


CYLINDER_INDEX = dict(
    feature_index_start=0,
    feature_index_end=2,
    output_index_start=0,
    output_index_end=2,
    node_type_index=2,
)


def simulator_pair(blocks: int, hidden: int):
    """(jax Simulator, port Simulator on the CPU) with the cylinder layout."""
    from graphphysics_tpu.models.processors import EncodeProcessDecode as JaxEPD
    from graphphysics_tpu.models.simulator import Simulator as JaxSim
    from graphphysics_tpu.models.simulator import SimulatorConfig as JaxCfg
    from graphphysics_torch.core import NodeType
    from graphphysics_torch.models import EncodeProcessDecode, Simulator, SimulatorConfig

    node_in = 2 + int(NodeType.SIZE)
    jax_sim = JaxSim(
        config=JaxCfg(node_input_size=node_in, edge_input_size=3, output_size=2, **CYLINDER_INDEX),
        model=JaxEPD(
            message_passing_num=blocks, node_input_size=node_in, edge_input_size=3,
            output_size=2, hidden_size=hidden,
        ),
    )
    port_sim = Simulator(
        SimulatorConfig(node_input_size=node_in, edge_input_size=3, output_size=2, **CYLINDER_INDEX),
        EncodeProcessDecode(blocks, node_in, 3, 2, hidden),
        device="cpu",
    )
    return jax_sim, port_sim


def write_cylinder_split(directory) -> tuple:
    """The small cylinder fixture of the checkpoint, resume, predict and CLI
    tests: ``write_cylinder_h5`` (2 trajectories of 6 frames on an 8 x 6
    grid, 5 items each) as ``train.h5``, copied to ``test.h5`` for the
    validation split. ``directory``'s own name must not contain "train"."""
    import shutil

    from graphphysics_tpu.utils.synthetic import write_cylinder_h5

    h5_path, meta_path = write_cylinder_h5(str(directory), num_traj=2, steps=6, nx=8, ny=6)
    shutil.copy(h5_path, str(directory / "test.h5"))
    return h5_path, meta_path


def cylinder_param(h5_path: str, meta_path: str, kind: str, blocks: int = 2, hidden: int = 16) -> dict:
    """A training config on the cylinder fixture: EncodeProcessDecode, or
    EncodeTransformDecode with 4 heads and no edge features."""
    model = {"type": "epd", "message_passing_num": blocks, "hidden_size": hidden,
             "node_input_size": 2, "output_size": 2, "edge_input_size": 3}
    if kind == "transformer":
        model = {"type": "transformer", "message_passing_num": blocks, "hidden_size": hidden,
                 "node_input_size": 2, "output_size": 2, "edge_input_size": 0, "num_heads": 4}
    return {
        "dataset": {"extension": "h5", "h5_path": h5_path, "meta_path": meta_path, "khop": 1},
        "model": model,
        "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                  "output_index_end": 2, "node_type_index": 2},
        "transformations": {
            "preprocessing": {"noise": 0.02, "noise_index_start": [0], "noise_index_end": [2],
                              "masking": 0},
            "world_pos_parameters": {"use": False},
        },
    }


def port_trainer(param: dict, directory, **kw):
    """(Trainer on the CPU writing under ``directory``, shuffled loader of
    2-frame batches, validation split) for ``param``."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing

    edges = param["model"]["edge_input_size"] > 0
    train_ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges),
                           use_edge_feature=edges)
    val_ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges, remove_noise=True),
                         use_edge_feature=edges, switch_to_val=True)
    kw = {"learning_rate": 1e-3, "warmup": 5, "log_every": 1,
          "checkpoint_dir": str(directory / "ckpt"), "metrics_path": str(directory / "metrics.csv"),
          "rollout_dir": str(directory / "meshes"), "device": "cpu", **kw}
    return Trainer(param, **kw), GraphLoader(train_ds, batch_size=2, shuffle=True), val_ds


# edge layouts of the kernel parity tests (``layout_graphs``)
LAYOUTS = ["n_pad_eq_n", "empty_rows", "two_graphs"]


def layout_graphs(pad, layout, seed, n_pad, size=None):
    """Graphs of one of ``LAYOUTS`` padded with ``pad``: n_pad == n with
    padding edges on the real last node; every edge into the first few
    nodes (most rows empty); or two graphs of other sizes concatenated.
    ``size`` (default ``n_pad``) scales the real nodes and edges of the
    last, for the small graphs of the gradient checks."""
    r = np.random.default_rng(seed)
    size = n_pad if size is None else size

    def one(n, e, hi=None):
        ends = r.integers(0, n if hi is None else hi, e).astype(np.int32)
        other = r.integers(0, n, e).astype(np.int32)
        s, recv = (other, ends) if pad is pad_graph_sorted_np else (ends, other)
        return pad(np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32), s, recv,
                   n_pad, 6 * size)

    if layout == "n_pad_eq_n":
        return one(n_pad, 5 * size)
    if layout == "empty_rows":
        return one(n_pad - n_pad // 6, 4 * size, hi=9)
    return concat_graphs([one(size - size // 8, 5 * size), one(3 * size // 4, 4 * size)])


def mask_some_edges(g):
    """``g``'s edge mask with every 7th edge masked too: masked edges inside
    the ranges."""
    mask = g.edge_mask.copy()
    mask[::7] = False
    return mask
