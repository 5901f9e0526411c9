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
