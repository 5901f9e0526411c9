"""Port parity, the memory knobs: ``remat`` (each block recomputed in the
backward, ``torch.utils.checkpoint``) computes the same function as the
plain blocks, bit for bit on the CPU, outputs and every parameter's
gradient, for both model families, in f32 and bf16, with and without
``scan_blocks`` (twins of ``test_remat.py``'s ``test_epd_remat_matches_coo``
and ``test_etd_remat_matches_coo``); a JAX ``scan_blocks`` model's stacked
weights, unstacked by ``unstack_scanned_blocks``, give the JAX output in
the port (twin of ``test_scan_blocks.py``'s
``test_scan_blocks_matches_unrolled``); ``get_model`` reads the knobs as
the JAX ``get_model`` does. Everything runs on the CPU; inputs come from
numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.torch_import import export_reference_state_dict
from graphphysics_torch.core import graph as port_graph
from graphphysics_torch.models import reset_parameters
from graphphysics_torch.training import get_model
from graphphysics_torch.utils.reference_weights import unstack_scanned_blocks
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# the port against the JAX scanned model, f32: 3 blocks of matmuls and
# exponentials in another order (XLA vs ATen), as the f32 model tests
RTOL, ATOL = 1e-5, 1e-5


def _param(kind, **knobs):
    model = {"type": kind, "message_passing_num": 3, "hidden_size": 16, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3 if kind == "epd" else 0, "num_heads": 4, **knobs}
    return {"model": model}


def _graphs(kind, seed, n=100, e=600, n_pad=128, e_pad=768):
    """One raw graph padded by the JAX padding (COO for EPD, CSR for the
    transformer) and by the port's (receiver-sorted, sender-sorted), the
    model's full input width as node features."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 11)).astype(np.float32)
    pos = r.normal(size=(n, 2)).astype(np.float32)
    s, t = r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32)
    if kind == "epd":
        ea = r.normal(size=(e, 3)).astype(np.float32)
        jg = jax_graph.pad_graph_np(x, pos, s, t, n_pad, e_pad, edge_attr=ea)
        g = port_graph.pad_graph_sorted_np(x, pos, s, t, n_pad, e_pad, edge_attr=ea)
    else:
        jg = jax_graph.pad_graph_csr_np(x, pos, s, t, n_pad, e_pad)
        g = port_graph.pad_graph_csr_np(x, pos, s, t, n_pad, e_pad)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, jg)
    return jg, g.to("cpu")


def _output_and_grads(model, g):
    out = model(g)
    mask = g.node_mask.to(torch.float32)[:, None]
    ((out ** 2 * mask).sum() / mask.sum()).backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("scan_blocks", [False, True])
@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_remat_is_bitwise_the_plain_blocks(kind, scan_blocks, precision):
    _, g = _graphs(kind, seed=1)
    base = get_model(_param(kind, precision=precision, scan_blocks=scan_blocks))
    reset_parameters(base, torch.Generator().manual_seed(0))
    rem = get_model(_param(kind, precision=precision, scan_blocks=scan_blocks, remat=True))
    rem.load_state_dict(base.state_dict(), strict=True)
    assert rem.remat and not base.remat
    out_b, grads_b = _output_and_grads(base, g)
    out_r, grads_r = _output_and_grads(rem, g)
    assert torch.equal(out_b, out_r)
    assert grads_b.keys() == grads_r.keys()
    for name in grads_b:
        assert torch.equal(grads_b[name], grads_r[name]), name


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_jax_scanned_weights_unstacked_give_the_jax_output(kind):
    jg, g = _graphs(kind, seed=2)
    param = _param(kind, scan_blocks=True)
    model = jax_pp.get_model(param)
    with pltpu.force_tpu_interpret_mode():
        params = model.init(jax.random.key(0), jg)["params"]
        want = np.asarray(model.apply({"params": params}, jg))
    assert "blocks" in params and "block_0" not in params
    assert np.shape(jax.tree_util.tree_leaves(params["blocks"])[0])[0] == 3
    unrolled = unstack_scanned_blocks({"model": params})
    assert sorted(k for k in unrolled["model"] if k.startswith("block")) == ["block_0", "block_1", "block_2"]
    state = {k[len("model."):]: torch.from_numpy(np.array(v, np.float32))
             for k, v in export_reference_state_dict(unrolled).items()}
    ours = get_model(param)
    ours.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = ours(g).numpy()
    real = np.asarray(g.node_mask)
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
    # the slices are the stacked leaves
    block = params["blocks"]["block"]
    first = jax.tree_util.tree_leaves(block)[0]
    np.testing.assert_array_equal(jax.tree_util.tree_leaves(unrolled["model"]["block_1"])[0],
                                  np.asarray(first)[1])
    # a tree without a scanned stack comes back as it is
    plain = {"model": {"block_0": {"w": np.zeros(2)}}}
    assert unstack_scanned_blocks(plain) == plain


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_knobs_reach_the_model_as_jax_get_model(kind):
    for knobs in ({}, {"precision": "bfloat16", "remat": True}, {"precision": "float32", "scan_blocks": True}):
        param = _param(kind, **knobs)
        jax_model = jax_pp.get_model(param)
        ours = get_model(param)
        assert ours.dtype == (None if jax_model.dtype is None else torch.bfloat16)
        assert (ours.remat, ours.scan_blocks) == (jax_model.remat, jax_model.scan_blocks)
        assert len(ours.processor_list) == jax_model.message_passing_num
