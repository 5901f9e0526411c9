"""Port parity, layers: RMSNorm, MLP and GraphNetBlock of
``graphphysics_torch.models.layers`` against the flax modules, with the flax
weights carried across by ``export_reference_state_dict``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.models import layers as jax_layers
from graphphysics_torch.core.graph import pad_graph_sorted_np
from graphphysics_torch.models.layers import MLP, GraphNetBlock, RMSNorm, reset_parameters
from tests._torch_port_common import state_dict_under

# f32 matmuls in another order (XLA vs ATen): a few ulps per layer
RTOL, ATOL = 1e-5, 1e-5


def test_rmsnorm_matches_flax_including_zero_row():
    r = np.random.default_rng(0)
    x = r.normal(size=(9, 16)).astype(np.float32)
    x[3] = 0.0  # all-zero row: the 1e-24 floor keeps it finite
    scale = r.normal(size=16).astype(np.float32)
    want = jax_layers.RMSNorm(16).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = RMSNorm(16)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    xt = torch.from_numpy(x).requires_grad_(True)
    got = norm(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(got[3].detach(), torch.zeros(16))
    got.sum().backward()
    assert torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("layer_norm", [True, False])
def test_mlp_matches_flax(layer_norm):
    r = np.random.default_rng(1)
    x = r.normal(size=(21, 7)).astype(np.float32)
    flax_mlp = jax_layers.MLP(hidden_size=24, out_size=5, layer_norm=layer_norm)
    params = flax_mlp.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = flax_mlp.apply({"params": params}, jnp.asarray(x))
    mlp = MLP(7, 24, 5, layer_norm=layer_norm)
    mlp.load_state_dict(state_dict_under("nodes_encoder", {"nodes_encoder": params}), strict=True)
    np.testing.assert_allclose(
        mlp(torch.from_numpy(x)).detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


def _block_case(seed=2, n=30, e=110, h=16, n_pad=32, e_pad=128):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n_pad, h)).astype(np.float32)
    ea = r.normal(size=(e_pad, h)).astype(np.float32)
    senders = r.integers(0, n, e).astype(np.int32)
    receivers = r.integers(0, n, e).astype(np.int32)
    return x, ea, senders, receivers, n, n_pad, e_pad


def _flax_block(x, ea, s, rcv, mask, h):
    block = jax_layers.GraphNetBlock(hidden_size=h)
    params = block.init(
        jax.random.key(2), jnp.asarray(x), jnp.asarray(ea), jnp.asarray(s), jnp.asarray(rcv),
        jnp.asarray(mask),
    )["params"]
    return block, params


def test_graphnet_block_matches_flax_coo():
    x, ea, s, rcv, n, n_pad, e_pad = _block_case()
    h = x.shape[1]
    s_p = np.full(e_pad, n_pad - 1, np.int32)
    r_p = s_p.copy()
    s_p[: len(s)], r_p[: len(rcv)] = s, rcv
    mask = np.arange(e_pad) < len(s)
    block, params = _flax_block(x, ea, s_p, r_p, mask, h)
    want_x, want_e = block.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(ea), jnp.asarray(s_p),
        jnp.asarray(r_p), jnp.asarray(mask),
    )
    ours = GraphNetBlock(h)
    ours.load_state_dict(state_dict_under("processor_list.0", {"block_0": params}), strict=True)
    got_x, got_e = ours(
        torch.from_numpy(x), torch.from_numpy(ea), torch.from_numpy(s_p),
        torch.from_numpy(r_p), torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_e.detach().numpy(), np.asarray(want_e), rtol=RTOL, atol=ATOL)


def test_graphnet_block_receiver_sorted_matches_flax():
    """Sorted layout with row bounds (the CUDA path's layout): node outputs
    equal flax on the unsorted graph; edge outputs after undoing the sort."""
    x, ea_real, s, rcv, n, n_pad, e_pad = _block_case(seed=3)
    h = x.shape[1]
    e = len(s)
    ea_real = ea_real[:e]
    unsorted = dict(s=s, r=rcv, ea=ea_real)
    g = pad_graph_sorted_np(
        x[:n], np.zeros((n, 2), np.float32), s, rcv, n_pad, e_pad, edge_attr=ea_real
    )
    mask_u = np.arange(e_pad) < e
    s_u = np.full(e_pad, n_pad - 1, np.int32)
    r_u = s_u.copy()
    s_u[:e], r_u[:e] = unsorted["s"], unsorted["r"]
    ea_u = np.zeros((e_pad, h), np.float32)
    ea_u[:e] = unsorted["ea"]
    block, params = _flax_block(x, ea_u, s_u, r_u, mask_u, h)
    want_x, want_e = block.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(ea_u), jnp.asarray(s_u),
        jnp.asarray(r_u), jnp.asarray(mask_u),
    )
    ours = GraphNetBlock(h)
    ours.load_state_dict(state_dict_under("processor_list.0", {"block_0": params}), strict=True)
    got_x, got_e = ours(
        torch.from_numpy(x), torch.from_numpy(g.edge_attr), torch.from_numpy(g.senders),
        torch.from_numpy(g.receivers), torch.from_numpy(g.edge_mask),
        torch.from_numpy(g.row_bounds),
    )
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    order = np.argsort(rcv, kind="stable")
    np.testing.assert_allclose(
        got_e.detach().numpy()[:e], np.asarray(want_e)[:e][order], rtol=RTOL, atol=ATOL
    )


def test_reset_parameters_is_seeded():
    a = reset_parameters(MLP(4, 8, 2), torch.Generator().manual_seed(5))
    b = reset_parameters(MLP(4, 8, 2), torch.Generator().manual_seed(5))
    c = reset_parameters(MLP(4, 8, 2), torch.Generator().manual_seed(6))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("weight"):
            assert not torch.equal(va, vc), k
