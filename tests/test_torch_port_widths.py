"""The fused attention's widths: the CUDA kernels take every width
``D <= MAX_WIDTH`` with ``D % H == 0``, by a fast lane geometry where a lane
count splits the row into power-of-two head partials and by the general
geometry (a masked column tail and per-head sums through shared memory)
everywhere else. On the CPU: the geometry the wrappers pick for every such
(D, H) in both layouts, the published widths keeping their fast geometries,
the argument checks, and the transformer at widths outside the fast
geometries (hidden 48 with 4 heads, 96 with 3, 40 with 8) against the JAX
one, eval outputs and training gradients. The kernels themselves run in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.models.processors import EncodeTransformDecode as JaxETD
from graphphysics_tpu.models.simulator import Simulator as JaxSim
from graphphysics_tpu.models.simulator import SimulatorConfig as JaxCfg
from graphphysics_tpu.training import losses as jax_losses
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint, export_reference_state_dict
from graphphysics_torch.core import NodeType
from graphphysics_torch.core.graph import pad_graph_csr_np
from graphphysics_torch.models import EncodeTransformDecode, Simulator, SimulatorConfig
from graphphysics_torch.ops import csr_attention as ca
from graphphysics_torch.training import l2_loss
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# the whole simulator in f32 in another order, then the normalizer's inverse
SIM_RTOL, SIM_ATOL = 1e-4, 1e-4
# gradients of the training loss through 2 blocks: f32 in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
PANELS_INDEX = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
                    output_index_end=3, node_type_index=3)
MASKS = [int(NodeType.NORMAL), int(NodeType.OUTFLOW)]


def _divisor_pairs(limit):
    return [(d, h) for d in range(1, limit + 1) for h in range(1, d + 1) if d % h == 0]


@pytest.mark.parametrize("interleaved", [False, True], ids=["contiguous", "model_view"])
def test_every_width_has_a_geometry(interleaved):
    """Every (D, H) with D % H == 0 and D <= 512 gets a lane count in both
    kernels, with a geometry the kernels take; a fast one wherever one
    exists, and the lane count's V = ceil(D / lanes) columns fit a lane."""
    kinds = {"fast": 0, "general": 0}
    for d, h in _divisor_pairs(ca.MAX_WIDTH):
        for backward in (False, True):
            lanes = ca.lanes_per_row(d, h, interleaved, backward=backward)
            assert lanes in (8, 16, 32), (d, h, backward)
            kind = ca.geometry_kind(lanes, d, h, interleaved)
            assert kind is not None and -(-d // lanes) <= ca.MAX_COLUMNS
            any_fast = any(ca._geometry_ok(g, d, h, interleaved) for g in (8, 16, 32))
            assert (kind == "fast") == any_fast, (d, h, lanes)
            kinds[kind] += 1
    assert kinds["fast"] and kinds["general"]
    assert ca.lanes_per_row(ca.MAX_WIDTH + 1, 1, interleaved) is None
    assert ca.geometry_kind(8, 48, 5, interleaved) is None  # 5 does not divide 48


def test_published_widths_keep_their_fast_geometries():
    """The model's widths (64 and 128, 4 heads, the (N, Dh, H) view) keep
    the lanes measured fastest: 8 forward, 32 backward, fast geometry; the
    widths of the general geometry's card phases take it in the model's
    layout."""
    for d in (64, 128):
        assert ca.lanes_per_row(d, 4, True) == 8 and ca.lanes_per_row(d, 4, True, backward=True) == 32
        assert ca.geometry_kind(8, d, 4, True) == ca.geometry_kind(32, d, 4, True) == "fast"
    # the general geometry: the fewest lanes with at most 3 columns each
    for (d, h), lanes in (((48, 4), 16), ((96, 3), 32), ((40, 8), 16), ((12, 4), 8), ((500, 5), 32)):
        for backward in (False, True):
            assert ca.lanes_per_row(d, h, True, backward=backward) == lanes, (d, h)
            assert ca.geometry_kind(lanes, d, h, True) == "general", (d, h)
    # blocked rows of 48 = 4 x 12 split into 2 lanes a head: fast
    assert ca.geometry_kind(8, 48, 4, False) == "fast"


def test_attention_checks_take_any_width_up_to_the_limit():
    """The argument checks raise only past ``MAX_WIDTH`` (the layout,
    dtype and index checks stay); the CPU path computes any width."""
    n = 128
    g = pad_graph_csr_np(np.zeros((100, 1), np.float32), np.zeros((100, 2), np.float32),
                         np.arange(300, dtype=np.int32) % 100, (np.arange(300, dtype=np.int32) * 7) % 100,
                         n, 384)
    bounds, gather = torch.from_numpy(g.sender_bounds), torch.from_numpy(g.receivers)
    for h, dh in ((4, 12), (3, 32), (8, 5), (5, 100)):
        q = torch.zeros(n, h, dh)
        assert ca._check_attention_args("t", q, q, q, gather, bounds, None) is False
        view = torch.zeros(n, dh, h).transpose(1, 2)
        assert ca._check_attention_args("t", view, view, view, gather, bounds, None) is (h > 1)
    with pytest.raises(ValueError, match="at most 512"):
        q = torch.zeros(n, 4, 160)
        ca._check_attention_args("t", q, q, q, gather, bounds, None)


def _graph(seed, n=100, e=600, n_pad=128, e_pad=768):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 5)).astype(np.float32)
    x[:, 3] = r.integers(0, 7, n)
    return pad_graph_csr_np(
        x, r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
        n_pad, e_pad, y=r.normal(size=(n, 3)).astype(np.float32), node_type_index=3,
    )


def _jax_graph(g):
    return JaxGraph(
        x=jnp.asarray(g.x), pos=jnp.asarray(g.pos), senders=jnp.asarray(g.senders),
        receivers=jnp.asarray(g.receivers), edge_attr=None, node_mask=jnp.asarray(g.node_mask),
        edge_mask=jnp.asarray(g.edge_mask), y=jnp.asarray(g.y),
    )


@pytest.mark.parametrize("hidden,heads", [(48, 4), (96, 3), (40, 8)])
def test_transformer_at_width_matches_jax(hidden, heads):
    """EncodeTransformDecode at a width outside the fast geometries against
    the JAX transformer: eval outputs, and the gradient of the training loss
    per parameter."""
    node_in = 2 + int(NodeType.SIZE)
    cfg = dict(node_input_size=node_in, edge_input_size=0, output_size=3, **PANELS_INDEX)
    jax_sim = JaxSim(config=JaxCfg(**cfg), model=JaxETD(
        message_passing_num=2, node_input_size=node_in, output_size=3, hidden_size=hidden,
        num_heads=heads))
    sim = Simulator(SimulatorConfig(**cfg), EncodeTransformDecode(2, node_in, 3, hidden, heads),
                    device="cpu")
    g = _graph(seed=hidden + heads)
    jg = _jax_graph(g)
    variables = jax_sim.init({"params": jax.random.key(0)}, jg)
    _, mut = jax_sim.apply(variables, jg, method=JaxSim.accumulate_stats, mutable=["normalizer"])
    variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))

    want = jax_sim.apply(variables, jg, is_training=False)
    with torch.no_grad():
        got = sim(g.to("cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SIM_RTOL, atol=SIM_ATOL)

    node_type = jnp.asarray(g.x[:, 3].astype(np.int32))

    def jax_loss(params):
        (out, target, _), _ = jax_sim.apply({"params": params, "normalizer": variables["normalizer"]},
                                            jg, is_training=True, accumulate_stats=False,
                                            mutable=["normalizer"])
        return jax_losses.l2_loss(target, out, node_type, MASKS, node_valid=jg.node_mask)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(variables["params"])
    gt = g.to("cpu")
    out, target, _ = sim(gt, is_training=True, accumulate_stats=False)
    loss = l2_loss(target, out, sim.node_type(gt), MASKS, node_valid=gt.node_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_sd = export_reference_state_dict({"model": want_grads["model"]})
    grads = dict(sim.named_parameters())
    for key, value in want_sd.items():
        if key.endswith("k_proj.bias"):  # 0 in exact arithmetic: round-off on both sides
            continue
        theirs = np.asarray(value, np.float32).reshape(grads[key].shape)
        np.testing.assert_allclose(grads[key].grad.numpy(), theirs, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=key)
