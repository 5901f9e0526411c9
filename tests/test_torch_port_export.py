"""Port twins of ``tests/test_export.py`` (``graphphysics_torch/utils/export.py``
through ``torch.export``): the loaded artifact reproduces the live eval
step and rollout; it agrees with the JAX package's eval step with the
weights carried over; and every kernel op's fake implementation gives the
shapes and dtypes of its CPU implementation. The partitioned artifact
(``test_export_partitioned_roundtrip_matches_single_device``) is in
``test_torch_port_export_partitioned.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core.graph import pad_graph_csr_np, pad_graph_sorted_np, stack_graphs
from graphphysics_torch.ops import csr_attention as ca
from graphphysics_torch.ops import csr_segment as cs
from graphphysics_torch.training import get_simulator, rollout
from graphphysics_torch.utils.export import (
    export_eval_step,
    export_rollout,
    load_eval_step,
    load_eval_step_file,
    load_rollout,
    save_eval_step,
)
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

PADS = {"epd": pad_graph_sorted_np, "transformer": pad_graph_csr_np}
# the artifact runs the same ops on the same inputs as the live step
RTOL, ATOL = 1e-6, 1e-6
# against JAX: f32 through 2 blocks in another summation order
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5


def _param(kind, K=0):
    model = {"type": kind, "message_passing_num": 2, "hidden_size": 16, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3 if kind == "epd" else 0,
             "num_mixture_components": K}
    if kind == "transformer":
        model["num_heads"] = 4
    return {"model": model, "index": {"feature_index_start": 0, "feature_index_end": 2,
                                      "output_index_start": 0, "output_index_end": 2,
                                      "node_type_index": 2}}


def _graph(kind, seed=0, n=48, e=160, n_pad=128, e_pad=256):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return PADS[kind](
        x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), n_pad, e_pad,
        edge_attr=r.normal(size=(e, 3)).astype(np.float32) if kind == "epd" else None,
        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    )


def _build(kind="epd", K=0):
    """A port simulator on the CPU whose normalizers have seen a graph (so
    the denormalization is not the identity), and that graph."""
    sim = get_simulator(_param(kind, K), device="cpu")
    g = _graph(kind).to("cpu")
    sim.accumulate_stats(g)
    return sim.eval(), g


def _live(sim, g, generator=None):
    with torch.no_grad():
        return sim(g, generator=generator)[2]


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_export_roundtrip_matches_live_eval(kind):
    sim, g = _build(kind)
    blob = export_eval_step(sim, g)
    assert isinstance(blob, bytes) and len(blob) > 0
    step = load_eval_step(blob)
    got = step(g)
    torch.testing.assert_close(got, _live(sim, g), rtol=RTOL, atol=RTOL)
    # another input graph flows through the baked weights too
    g2 = _graph(kind, seed=5).to("cpu")
    got2 = step(g2)
    torch.testing.assert_close(got2, _live(sim, g2), rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, got2)


def test_export_file_roundtrip(tmp_path):
    sim, g = _build()
    path = save_eval_step(str(tmp_path / "serve.pt2"), sim, g)
    step = load_eval_step_file(path)
    torch.testing.assert_close(step(g), _live(sim, g), rtol=RTOL, atol=ATOL)
    other = g.replace(edge_attr=None)
    with pytest.raises(ValueError, match="not the exported"):
        step(other)


def test_export_gmm_takes_sample_draws():
    """A GMM head's artifact takes its draws as tensors: the loaded step
    makes them from the caller's generator and samples what the live
    model samples from a generator of the same seed."""
    sim, g = _build(K=3)
    step = load_eval_step(export_eval_step(sim, g))
    got = step(g, generator=torch.Generator().manual_seed(42))
    torch.testing.assert_close(got, _live(sim, g, torch.Generator().manual_seed(42)),
                               rtol=RTOL, atol=ATOL)
    other = step(g, generator=torch.Generator().manual_seed(7))
    assert not torch.allclose(got, other)
    with pytest.raises(ValueError, match="generator"):
        step(g)


@pytest.mark.parametrize("kind,K", [("epd", 0), ("transformer", 0), ("epd", 3)])
def test_export_rollout_matches_live(kind, K):
    sim, _ = _build(kind, K)
    frames = stack_graphs([_graph(kind, seed=s) for s in range(4)]).to("cpu")
    run = load_rollout(export_rollout(sim, frames))
    gen = (lambda: torch.Generator().manual_seed(3)) if K else (lambda: None)
    pred, tgt = run(frames, generator=gen())
    assert pred.shape == tgt.shape == (4, frames.x.shape[1], 2)
    live_pred, live_tgt = rollout(sim, frames, device="cpu", generator=gen())
    torch.testing.assert_close(pred, live_pred, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tgt, live_tgt, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_exported_eval_step_matches_the_jax_eval_step(kind):
    """The artifact, exported from the port simulator that carries the
    JAX weights and statistics, against the JAX package's eval forward on
    the same graph (its COO layout)."""
    g = _graph(kind)
    jg = JaxGraph(x=jnp.asarray(g.x), pos=jnp.asarray(g.pos), senders=jnp.asarray(g.senders),
                  receivers=jnp.asarray(g.receivers),
                  edge_attr=None if g.edge_attr is None else jnp.asarray(g.edge_attr),
                  node_mask=jnp.asarray(g.node_mask), edge_mask=jnp.asarray(g.edge_mask),
                  y=jnp.asarray(g.y))
    jax_sim = jax_pp.get_simulator(_param(kind))
    variables = jax_sim.init({"params": jax.random.key(0)}, jg)
    _, mut = jax_sim.apply(variables, jg, is_training=True, mutable=["normalizer"])
    variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    want = np.asarray(jax_sim.apply(variables, jg, is_training=False)[2])

    sim = get_simulator(_param(kind), device="cpu")
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    got = load_eval_step(export_eval_step(sim.eval(), g.to("cpu")))(g.to("cpu"))
    real = np.asarray(g.node_mask)
    np.testing.assert_allclose(got.numpy()[real], want[real], rtol=JAX_RTOL, atol=JAX_ATOL)


def test_exported_program_calls_the_kernel_ops():
    """The traced program holds the ops of the port's namespace (so on CUDA
    tensors it launches the kernels) and none of their plain versions."""
    import io

    for kind, op in (("epd", "csr_segment_sum"), ("transformer", "csr_attention")):
        sim, g = _build(kind)
        program = torch.export.load(io.BytesIO(export_eval_step(sim, g)))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count(f"graphphysics_torch.{op}.default") == 2, kind  # one per block


def _segment_inputs():
    g = _graph("epd")
    data = torch.randn(g.num_edges, 8, generator=torch.Generator().manual_seed(0))
    return g, data


def _attention_inputs(dtype):
    g = _graph("transformer")
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(g.num_nodes, 16, 4, generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))  # the model's (N, Dh, H) views
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
            torch.from_numpy(g.sender_bounds), torch.from_numpy(g.edge_mask))
    return q, k, v, args


OPS = ["csr_segment_sum", "csr_segment_sum_backward", "csr_softmax_spmm",
       "csr_softmax_spmm_backward", "csr_softmax_spmm_pair", "csr_softmax_spmm_pair_backward",
       *[f"{name}_{dtype}" for dtype in ("float32", "bfloat16", "float64")
         for name in ("csr_attention", "csr_attention_backward")]]


def _op_case(name):
    """``(op, args)`` of one kernel op at a small size on the CPU."""
    g, data = _segment_inputs()
    rec, rb, em = (torch.from_numpy(a) for a in (g.receivers, g.row_bounds, g.edge_mask))
    if name == "csr_segment_sum":
        return cs._segment_sum_op, (data, rec, rb, em)
    if name == "csr_segment_sum_backward":
        return cs._segment_sum_backward_op, (torch.randn(g.num_nodes, 8), rec, rb, em)
    scores, values = torch.randn(g.num_edges, 4), torch.randn(g.num_edges, 32)
    if name == "csr_softmax_spmm":
        return ca._softmax_spmm_op, (scores, values, rec, rb, em)
    if name == "csr_softmax_spmm_backward":
        out, ml = ca.csr_softmax_spmm(scores, values, rec, rb, em)
        return ca._softmax_spmm_backward_op, (scores, values, rec, rb, ml, out, torch.randn_like(out), em)
    # the pair's second set: 8 edges, all masked, in empty ranges
    b = (scores[:8], values[:8], rec[:8], torch.zeros_like(rb), torch.zeros(8, dtype=torch.bool))
    if name == "csr_softmax_spmm_pair":
        return ca._pair_op, (scores, values, rec, rb, em, *b)
    if name == "csr_softmax_spmm_pair_backward":
        out, ml = ca.csr_softmax_spmm_pair(scores, values, rec, rb, *b[:4], em, b[4])
        return ca._pair_backward_op, (scores, values, rec, rb, *b[:4], ml, out,
                                      torch.randn_like(out), em, b[4])
    op, dtype = name.rsplit("_", 1)
    q, k, v, (seg, gather, bounds, mask) = _attention_inputs(getattr(torch, dtype))
    tc = ca._gather_args(ca.gather_csr(seg, gather, bounds, mask))
    if op == "csr_attention":
        return ca._attention_op, (q, k, v, seg, gather, bounds, mask, 0.5, *tc)
    out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, 0.5)
    return ca._attention_backward_op, (q, k, v, seg, gather, bounds, ml, out, torch.randn_like(out),
                                       mask, 0.5, *tc)


@pytest.mark.parametrize("name", OPS)
def test_fake_implementation_gives_the_cpu_shapes_and_dtypes(name):
    """Each op's fake implementation (what ``torch.export`` traces) against
    its CPU implementation on the same inputs: shapes, dtypes and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_case(name)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype, f.stride()) == (tuple(r.shape), r.dtype, r.stride())
