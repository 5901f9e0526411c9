"""Port twin of ``graphphysics_tpu.ops.halo.stub_exchange_for_benchmark``
(``graphphysics_torch/ops/halo.py``): under the stub the halo exchange is
the identity. The port's ``halo_recv`` and ``halo_table`` give each part's
rows equal to the JAX ones under the JAX stub, on the same numpy inputs
(JAX under ``shard_map`` over the CPU devices, the port part by part with
no process group), f32 and with the bf16 wire; the gradient through the
stub is the identity's; the primitive in place before the context is back
after it, also after an exception."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_torch.ops import halo
from graphphysics_tpu.ops import halo as jax_halo
from graphphysics_tpu.parallel import make_mesh
from graphphysics_tpu.parallel.mesh import GRAPH_AXIS
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

PARTS, ROWS, BUDGET, WIDTH = 4, 6, 3, 5


def _inputs(seed=0):
    """Every part's ``[ROWS, WIDTH]`` rows, the ``[P, B]`` local rows it
    sends each peer, and a cotangent of its exchange table."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(PARTS, ROWS, WIDTH)).astype(np.float32)
    send_idx = r.integers(0, ROWS, size=(PARTS, PARTS, BUDGET)).astype(np.int32)
    cot = r.normal(size=(PARTS, ROWS + PARTS * BUDGET, WIDTH)).astype(np.float32)
    return x, send_idx, cot


def _jax_per_part(fn, *arrays):
    """``fn`` of each part's arrays under ``shard_map`` over PARTS CPU
    devices; the results stacked by part."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(PARTS, (GRAPH_AXIS,))

    def per_part(*local):
        return fn(*(a[0] for a in local))[None]

    mapped = shard_map(per_part, mesh=mesh, in_specs=(P(GRAPH_AXIS),) * len(arrays),
                       out_specs=P(GRAPH_AXIS), check_vma=False)
    return np.asarray(jax.jit(mapped)(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("wire", [None, "bf16"])
@pytest.mark.parametrize("what", ["halo_recv", "halo_table"])
def test_stubbed_exchange_matches_jax(what, wire):
    x, send_idx, _ = _inputs()
    with jax_halo.stub_exchange_for_benchmark():  # read while the step is traced
        want = _jax_per_part(
            lambda xl, il: getattr(jax_halo, what)(xl, il, GRAPH_AXIS, wire), x, send_idx)
    with halo.stub_exchange_for_benchmark():
        got = [getattr(halo, what)(torch.from_numpy(x[p]), torch.from_numpy(send_idx[p]),
                                   GRAPH_AXIS, wire).numpy() for p in range(PARTS)]
    for p in range(PARTS):
        assert got[p].dtype == want[p].dtype
        np.testing.assert_array_equal(got[p], want[p])
    # the identity: each part reads back the rows it sent
    rows = x[0][send_idx[0].reshape(-1)]
    if wire:
        rows = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[0][-PARTS * BUDGET:], rows)


@pytest.mark.parametrize("wire", [None, "bf16"])
def test_stubbed_gradient_is_the_identity_exchange_gradient(wire):
    x, send_idx, cot = _inputs(seed=1)

    def jax_loss(xl, il, cl):
        return jnp.sum(jax_halo.halo_table(xl, il, GRAPH_AXIS, wire) * cl)

    with jax_halo.stub_exchange_for_benchmark():
        want = _jax_per_part(jax.grad(jax_loss), x, send_idx, cot)
    for p in range(PARTS):
        xp = torch.from_numpy(x[p]).requires_grad_(True)
        with halo.stub_exchange_for_benchmark():
            table = halo.halo_table(xp, torch.from_numpy(send_idx[p]), GRAPH_AXIS, wire)
            (table * torch.from_numpy(cot[p])).sum().backward()
        # the identity's transpose: the cotangent of the local rows, plus
        # the halo rows' cotangent (rounded to the wire) summed into the rows sent
        halo_cot = torch.from_numpy(cot[p][ROWS:])
        if wire:
            halo_cot = halo_cot.to(torch.bfloat16).float()
        expected = torch.from_numpy(cot[p][:ROWS]).index_add(
            0, torch.from_numpy(send_idx[p].reshape(-1)).long(), halo_cot)
        np.testing.assert_allclose(xp.grad.numpy(), expected.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(xp.grad.numpy(), want[p], rtol=1e-6, atol=1e-6)


def test_stub_restores_the_primitive_in_place(monkeypatch):
    events = []

    class Recorded:
        def __init__(self, send):
            self.send = send

        def wait(self):
            events.append("wait")
            return self.send.clone()

    def recording(send, axis_name, async_op=False):
        events.append("start")
        return Recorded(send)

    monkeypatch.setattr(halo, "exchange", recording)
    x, send_idx, _ = _inputs(seed=2)
    xt, it = torch.from_numpy(x[0]), torch.from_numpy(send_idx[0])
    with halo.stub_exchange_for_benchmark():
        assert halo.exchange is not recording
        halo.halo_table(xt, it, GRAPH_AXIS)
    assert events == [] and halo.exchange is recording
    with pytest.raises(RuntimeError, match="inside the stub"):
        with halo.stub_exchange_for_benchmark():
            raise RuntimeError("inside the stub")
    assert halo.exchange is recording
    halo.halo_table(xt, it, GRAPH_AXIS)
    assert events == ["start", "wait"]  # the stand-in works again
    monkeypatch.undo()
    assert halo.exchange is halo.all_to_all
