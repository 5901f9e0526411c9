"""Port twins of ``tests/test_torch_import.py``: reference-format weights
(the torch replicas of the reference module tree that the JAX test builds)
load into the port's models and Simulator by name
(``utils/reference_weights.py``, ``training/checkpoint.py``), and the port
runs them as the reference does."""

import numpy as np
import pytest
import torch

from graphphysics_torch.core import NodeType
from graphphysics_torch.core.graph import pad_graph_np
from graphphysics_torch.models import (
    EncodeProcessDecode,
    EncodeTransformDecode,
    Simulator,
    SimulatorConfig,
)
from graphphysics_torch.training import load_checkpoint, save_checkpoint
from graphphysics_torch.utils.reference_weights import _tensor, load_reference_checkpoint
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)
from tests.test_torch_import import (
    TorchEPD,
    TorchETD,
    TorchGraphNetBlock,
    torch_build_mlp,
)


def _graph(rng, n, e, node_in, edge_in, senders=None, receivers=None):
    x = rng.normal(size=(n, node_in)).astype(np.float32)
    s = rng.integers(0, n, e).astype(np.int32) if senders is None else senders.astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32) if receivers is None else receivers.astype(np.int32)
    ea = rng.normal(size=(e, edge_in)).astype(np.float32) if edge_in else None
    g = pad_graph_np(x, np.zeros((n, 2), np.float32), s, r, n, e, edge_attr=ea)
    return g.to("cpu"), x, s, r, ea


def _load(model, torch_model):
    model.load_state_dict({k: v.float() for k, v in torch_model.state_dict().items()}, strict=True)
    return model


def test_epd_state_dict_import_forward_parity(rng):
    n, e, hidden = 24, 80, 16
    graph, x, s, r, ea = _graph(rng, n, e, 5, 3)
    torch_model = TorchEPD(2, 5, 3, 2, hidden).double()
    model = _load(EncodeProcessDecode(2, 5, 3, 2, hidden), torch_model)
    with torch.no_grad():
        ours = model(graph).numpy()
        golden = torch_model(torch.tensor(x, dtype=torch.float64), torch.tensor(s, dtype=torch.long),
                             torch.tensor(r, dtype=torch.long),
                             torch.tensor(ea, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(ours, golden, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("separate", [True, False])
def test_etd_state_dict_import_forward_parity(rng, separate):
    """A reference transformer, its q/k/v weights separate or shared (the
    port loads shared ones as three equal weights with their own biases)."""
    n, hidden, heads = 18, 16, 4
    adj = rng.random((n, n)) > 0.6
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    s, r = np.nonzero(adj)
    graph, x, _, _, _ = _graph(rng, n, len(s), 5, 0, senders=s, receivers=r)
    torch_model = TorchETD(2, 5, 2, hidden, heads, use_separate_proj_weight=separate).double()
    if not separate:
        with torch.no_grad():  # biases trained apart on the shared-weight projections
            torch_model.processor_list[0].attention.k_proj.bias.add_(0.3)
            torch_model.processor_list[1].attention.v_proj.bias.add_(-0.2)
    model = _load(EncodeTransformDecode(2, 5, 2, hidden_size=hidden, num_heads=heads), torch_model)
    with torch.no_grad():
        ours = model(graph).numpy()
        golden = torch_model(torch.tensor(x, dtype=torch.float64), torch.tensor(adj)).numpy()
    np.testing.assert_allclose(ours, golden, rtol=1e-4, atol=1e-5)


def _simulator(hidden=8, blocks=1):
    cfg = SimulatorConfig(node_input_size=2 + int(NodeType.SIZE), edge_input_size=3, output_size=2,
                          feature_index_start=0, feature_index_end=2, output_index_start=0,
                          output_index_end=2, node_type_index=2)
    return Simulator(cfg, EncodeProcessDecode(blocks, cfg.node_input_size, 3, 2, hidden),
                     device="cpu")


def _reference_checkpoint(torch_model, node_in, edge_normalizer=True):
    return {
        "model": {f"model.{k}": v for k, v in torch_model.state_dict().items()},
        "_output_normalizer": {"_acc_count": torch.tensor(10.0),
                               "_num_accumulations": torch.tensor(2.0),
                               "_acc_sum": torch.arange(2, dtype=torch.float32) + 1,
                               "_acc_sum_squared": torch.arange(2, dtype=torch.float32) + 5},
        "_node_normalizer": {"_acc_count": torch.tensor(4.0),
                             "_num_accumulations": torch.tensor(1.0),
                             "_acc_sum": torch.zeros(node_in),
                             "_acc_sum_squared": torch.ones(node_in)},
        "_edge_normalizer": {"_acc_count": torch.tensor(7.0),
                             "_num_accumulations": torch.tensor(3.0),
                             "_acc_sum": torch.ones(3),
                             "_acc_sum_squared": torch.ones(3) * 2} if edge_normalizer else None,
    }


def test_mismatched_checkpoint_is_refused():
    """A reference checkpoint of another architecture does not load
    quietly: a missing block, or a normalizer of another width, raises (the
    twin of the JAX test's refusal of separate q/k/v weights in a shared
    model, which the port, always separate, cannot have)."""
    sim = _simulator(blocks=2)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(sim, _reference_checkpoint(TorchEPD(1, 11, 3, 2, 8), 11))
    ckpt = _reference_checkpoint(TorchEPD(2, 11, 3, 2, 8), 11)
    ckpt["_node_normalizer"]["_acc_sum"] = torch.zeros(12)
    with pytest.raises(ValueError, match="_node_normalizer._acc_sum"):
        load_reference_checkpoint(sim, ckpt)


def test_simulator_checkpoint_import_and_roundtrip(rng, tmp_path):
    """A full reference checkpoint (model and normalizer dicts) into the
    port Simulator; then the port's save and load round-trip it exactly."""
    sim = _simulator()
    torch_model = TorchEPD(1, sim.config.node_input_size, 3, 2, 8)
    load_reference_checkpoint(sim, _reference_checkpoint(torch_model, sim.config.node_input_size))
    sd = sim.state_dict()
    assert float(sd["_output_normalizer._acc_count"]) == 10.0
    np.testing.assert_allclose(sd["_output_normalizer._acc_sum"].numpy(), [1.0, 2.0])
    np.testing.assert_allclose(sd["_edge_normalizer._acc_sum_squared"].numpy(), [2.0, 2.0, 2.0])
    torch.testing.assert_close(sd["model.nodes_encoder.0.weight"], torch_model.nodes_encoder[0].weight)

    path = str(tmp_path / "sim.pt")
    save_checkpoint(path, sim)
    again = load_checkpoint(path, _simulator())
    for key, value in again.state_dict().items():
        assert torch.equal(value, sd[key]), key

    n, e = 20, 60
    xr = rng.normal(size=(n, 4)).astype(np.float32)
    xr[:, 2] = rng.integers(0, 7, n)
    g = pad_graph_np(xr, np.zeros((n, 2), np.float32), rng.integers(0, n, e).astype(np.int32),
                     rng.integers(0, n, e).astype(np.int32), n, e,
                     edge_attr=rng.normal(size=(e, 3)).astype(np.float32),
                     y=rng.normal(size=(n, 2)).astype(np.float32), node_type_index=2)
    out, _, _ = sim(g.to("cpu"), is_training=True)
    assert torch.isfinite(out).all()


def test_load_checkpoint_autodetects_torch_file(tmp_path):
    """``load_checkpoint`` takes a plain reference ``torch.save`` file into a
    Trainer: weights and normalizers from the file, the optimizer and the
    step fresh."""
    from graphphysics_torch.training import Trainer, is_torch_checkpoint

    param = {"model": {"type": "epd", "message_passing_num": 1, "hidden_size": 8,
                       "node_input_size": 2, "output_size": 2, "edge_input_size": 3},
             "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                       "output_index_end": 2, "node_type_index": 2}}
    trainer = Trainer(param, metrics_path=None, rollout_dir=None, device="cpu")
    trainer.init_state(10)
    torch_model = TorchEPD(1, 2 + int(NodeType.SIZE), 3, 2, 8)
    path = str(tmp_path / "reference.ckpt")
    torch.save(_reference_checkpoint(torch_model, 2 + int(NodeType.SIZE)), path)
    assert is_torch_checkpoint(path)
    load_checkpoint(path, trainer)
    torch.testing.assert_close(trainer.sim.model.nodes_encoder[0].weight,
                               torch_model.nodes_encoder[0].weight)
    assert float(trainer.sim.state_dict()["_output_normalizer._acc_count"]) == 10.0
    assert trainer.step == 0 and trainer.optimizer.state_dict()["state"] == {}


def test_gmm_head_import(rng):
    n, e, hidden, K, d = 12, 30, 8, 3, 2
    graph, x, s, r, ea = _graph(rng, n, e, 5, 3)

    class TorchDiagGMMHead(torch.nn.Module):
        def __init__(self, input_dim, d, K):
            super().__init__()
            self.pre_proj = torch.nn.Linear(input_dim, input_dim)
            self.proj = torch.nn.Linear(input_dim, K * (2 * d + 1))

        def forward(self, x):
            return self.proj(self.pre_proj(x))

    class TorchEPDGMM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.nodes_encoder = torch_build_mlp(5, hidden, hidden)
            self.edges_encoder = torch_build_mlp(3, hidden, hidden)
            self.decode_module = TorchDiagGMMHead(hidden, d, K)
            self.processor_list = torch.nn.ModuleList([TorchGraphNetBlock(hidden)])

        def forward(self, x, senders, receivers, edge_attr):
            x = self.nodes_encoder(x)
            edge_attr = self.edges_encoder(edge_attr)
            for block in self.processor_list:
                x, edge_attr = block(x, senders, receivers, edge_attr)
            return self.decode_module(x)

    torch_model = TorchEPDGMM().double()
    model = _load(EncodeProcessDecode(1, 5, 3, d, hidden, num_mixture_components=K), torch_model)
    with torch.no_grad():
        ours = model(graph).numpy()
        golden = torch_model(torch.tensor(x, dtype=torch.float64), torch.tensor(s, dtype=torch.long),
                             torch.tensor(r, dtype=torch.long),
                             torch.tensor(ea, dtype=torch.float64)).numpy()
    assert ours.shape == (n, K * (2 * d + 1))
    np.testing.assert_allclose(ours, golden, rtol=1e-4, atol=1e-5)


def test_bf16_reference_tensors_import():
    """Tensors saved by bf16 reference training load as float32, and int
    tensors (step counters) convert too."""
    out = _tensor(torch.ones(3, 2, dtype=torch.bfloat16) * 1.5)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, torch.full((3, 2), 1.5))
    assert _tensor(torch.arange(4)).dtype == torch.float32
    assert _tensor(np.ones(2, np.float16)).dtype == torch.float32
