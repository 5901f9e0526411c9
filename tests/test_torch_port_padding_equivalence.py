"""Port twins of ``tests/test_padding_equivalence.py``: the port's models
give the same outputs on a graph's real rows whether it is padded tightly
or with extra nodes and edges, in each edge layout they take on the CPU."""

import numpy as np
import pytest
import torch

from graphphysics_torch.core.graph import pad_graph_csr_np, pad_graph_np, pad_graph_sorted_np
from graphphysics_torch.models import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_torch.models.layers import reset_parameters
from graphphysics_torch.topology.build import to_undirected
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

PADS = {"coo": pad_graph_np, "sorted": pad_graph_sorted_np, "csr": pad_graph_csr_np}


def _raw(n=60, seed=0):
    r = np.random.default_rng(seed)
    s = r.integers(0, n, 3 * n).astype(np.int32)
    t = (s + r.integers(1, 10, 3 * n)).astype(np.int32) % n
    S, R = to_undirected(s, t)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    pos = r.normal(size=(n, 2)).astype(np.float32)
    ea = r.normal(size=(len(S), 3)).astype(np.float32)
    y = r.normal(size=(n, 2)).astype(np.float32)
    return x, pos, S, R, ea, y


def _pair(layout, n_extra, e_extra, edges=True):
    x, pos, S, R, ea, y = _raw()
    n, e = len(x), len(S)
    pad = PADS[layout]
    # the CSR padding takes whole 128-node blocks: its tightest is one block
    n_tight = 128 if layout == "csr" else n
    kw = dict(edge_attr=ea if edges else None, y=y, node_type_index=2)
    tight = pad(x, pos, S, R, n_tight, e, **kw).to("cpu")
    loose = pad(x, pos, S, R, tight.num_nodes + n_extra, e + e_extra, **kw).to("cpu")
    return tight, loose, n


def _outputs(model, tight, loose, n):
    reset_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model(tight)[:n], model(loose)[:n]


@pytest.mark.parametrize("layout", ["coo", "sorted"])
def test_epd_padding_equivalence(layout):
    tight, loose, n = _pair(layout, 24, 100)
    model = EncodeProcessDecode(2, 4, 3, 2, 16)
    out_t, out_l = _outputs(model, tight, loose, n)
    torch.testing.assert_close(out_l, out_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_transformer_padding_equivalence(layout):
    tight, loose, n = _pair(layout, 128, 100, edges=False)
    model = EncodeTransformDecode(2, 4, 2, hidden_size=16, num_heads=4)
    out_t, out_l = _outputs(model, tight, loose, n)
    torch.testing.assert_close(out_l, out_t, rtol=1e-5, atol=1e-6)
