"""Port parity, the fixed-degree ELL edge layout: ``topology.ell.build_ell``
and ``pad_graph_ell_np`` bit for bit against the JAX package's, the ELL ops
(``ops.ell_ops``) forward and gradient against JAX's, ``concat_graphs``
offsetting ``twin_perm``, ``GraphNetBlock`` and ``Attention`` on ELL
graphs against the JAX ELL modules and against the port's own sorted and
CSR layouts, the dataset's ELL degree budget and items against the JAX
``H5Dataset``'s, 10 train steps of each family against the JAX
``Trainer``, and remat on the ELL layout (twins of ``tests/test_ell.py``
and ``tests/test_remat.py::test_epd_remat_ell_layout``). Everything runs
on the CPU from seeded numpy inputs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.models import layers as jax_layers
from graphphysics_tpu.ops import ell_ops as jax_ell
from graphphysics_tpu.topology import ell as jax_topology_ell
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.synthetic import write_cylinder_h5
from graphphysics_tpu.utils.torch_import import (
    export_reference_checkpoint,
    export_reference_state_dict,
)
from graphphysics_torch.core.graph import (
    concat_graphs,
    pad_graph_csr_np,
    pad_graph_ell_np,
    pad_graph_sorted_np,
    stack_graphs,
)
from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.dataset.dataset import BaseDataset
from graphphysics_torch.dataset.sample import RawSample
from graphphysics_torch.models import reset_parameters
from graphphysics_torch.models.layers import Attention, GraphNetBlock
from graphphysics_torch.ops.csr_attention import csr_attention, csr_attention_backward
from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward
from graphphysics_torch.ops.ell_ops import ell_gather, ell_repeat, ell_segment_sum, ell_softmax
from graphphysics_torch.topology import build_ell, to_undirected
from graphphysics_torch.training import Trainer, get_dataset, get_model, get_preprocessing
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import cylinder_param, state_dict_under

# f32 sums in another order (XLA vs ATen), as the other layer tests
RTOL, ATOL = 1e-5, 1e-5
# gradients through a block: f32 sums of a few hundred terms in another
# order; atol is this share of the largest gradient (values up to ~7 here)
GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-5
# 10 train steps, as tests/test_torch_port_training.py
STEP_RTOL = 2e-5
KERNELS = (csr_segment_sum, csr_segment_sum_backward, csr_attention, csr_attention_backward)


def _launches():
    return tuple(k.launches for k in KERNELS)


def _sym_edges(n=32, seed=0):
    r = np.random.default_rng(seed)
    s = r.integers(0, n, 3 * n).astype(np.int32)
    t = r.integers(0, n, 3 * n).astype(np.int32)
    return to_undirected(s, t)


def _tensor(a):
    return torch.from_numpy(np.asarray(a))


def _close_grads(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_SHARE * np.abs(want).max(),
                               err_msg=msg)


def _attention_state_dict(params):
    """The port ``Attention``'s state_dict of a flax ``Attention``'s params."""
    sd = {}
    for name in ("q_proj", "k_proj", "v_proj", "proj"):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(params[name]["kernel"], np.float32).T.copy())
        if "bias" in params[name]:
            sd[f"{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"], np.float32))
    return sd


# --------------------------------------------------------------- topology


@pytest.mark.parametrize("seed,degree", [(0, None), (1, None), (2, 24)])
def test_build_ell_matches_jax_bit_for_bit(seed, degree):
    n = 40
    s, r = _sym_edges(n, seed)
    ours = build_ell(s, r, n, degree=degree)
    theirs = jax_topology_ell.build_ell(s, r, n, degree=degree)
    assert ours.degree == theirs.degree
    for field in ("senders", "receivers", "edge_mask", "edge_perm", "twin_perm"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_build_ell_invariants():
    n = 32
    s, r = _sym_edges(n)
    ell = build_ell(s, r, n)
    d = ell.degree
    np.testing.assert_array_equal(ell.receivers, np.repeat(np.arange(n), d))
    real = ell.edge_mask
    assert set(zip(ell.senders[real].tolist(), ell.receivers[real].tolist())) == set(
        zip(s.tolist(), r.tolist()))
    np.testing.assert_array_equal(ell.senders[~real], ell.receivers[~real])
    # senders[e] == owner(twin[e]) for every slot, and the twin is an involution
    np.testing.assert_array_equal(ell.senders, ell.receivers[ell.twin_perm])
    np.testing.assert_array_equal(ell.twin_perm[ell.twin_perm], np.arange(n * d))


def test_build_ell_refuses_what_jax_refuses():
    s, r = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    for fn in (build_ell, jax_topology_ell.build_ell):
        with pytest.raises(ValueError, match="not symmetric"):
            fn(s, r, 4)
    s, r = _sym_edges(16, 3)
    for fn in (build_ell, jax_topology_ell.build_ell):
        with pytest.raises(ValueError, match="exceeds ELL degree"):
            fn(s, r, 16, degree=2)


def _raw(n=48, seed=3):
    rng = np.random.default_rng(seed)
    s, r = _sym_edges(n, seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = rng.integers(0, 7, n)
    pos = rng.normal(size=(n, 2)).astype(np.float32)
    ea = rng.normal(size=(len(s), 3)).astype(np.float32)
    y = rng.normal(size=(n, 2)).astype(np.float32)
    return dict(x=x, pos=pos, senders=s, receivers=r, edge_attr=ea, y=y, node_type_index=2)


def test_pad_graph_ell_matches_jax_bit_for_bit():
    raw = _raw()
    ours = pad_graph_ell_np(**raw, n_pad=64, degree=16)
    theirs = jax_graph.pad_graph_ell_np(**raw, n_pad=64, degree=16)
    assert ours.ell_degree == theirs.ell_degree == 16
    for field in ("x", "pos", "senders", "receivers", "edge_attr", "node_mask", "edge_mask", "y",
                  "twin_perm"):
        a, b = getattr(ours, field), np.asarray(getattr(theirs, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_concat_offsets_twin_perm_as_jax_and_refuses_mixes():
    graphs = [pad_graph_ell_np(**_raw(seed=s), n_pad=64, degree=16) for s in (4, 5, 6)]
    jgraphs = [jax_graph.pad_graph_ell_np(**_raw(seed=s), n_pad=64, degree=16) for s in (4, 5, 6)]
    ours, theirs = concat_graphs(graphs), jax_graph.concat_graphs(jgraphs)
    assert ours.ell_degree == theirs.ell_degree == 16
    for field in ("senders", "receivers", "twin_perm", "edge_mask", "edge_attr"):
        assert np.array_equal(getattr(ours, field), np.asarray(getattr(theirs, field))), field
    # the twin invariant holds across the batch: every graph's gradients right
    np.testing.assert_array_equal(ours.senders, ours.receivers[ours.twin_perm])
    other = pad_graph_ell_np(**_raw(seed=7), n_pad=64, degree=20)
    with pytest.raises(ValueError):  # another degree (and so another edge count)
        concat_graphs([graphs[0], other])
    sorted_g = pad_graph_sorted_np(**{k: v for k, v in _raw(seed=4).items()}, n_pad=64, e_pad=64 * 16)
    with pytest.raises(ValueError, match="some graphs have"):  # ELL beside sorted
        concat_graphs([graphs[0], sorted_g])
    stacked = stack_graphs(graphs)
    assert stacked.ell_degree == 16 and stacked[1].ell_degree == 16
    assert stacked.to("cpu")[2].twin_perm.dtype == torch.int32


# --------------------------------------------------------------------- ops


def test_ell_ops_match_jax_forward_and_gradient():
    n = 32
    s, r = _sym_edges(n, seed=1)
    ell = build_ell(s, r, n)
    d = ell.degree
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n * d, 8)).astype(np.float32)
    scores = rng.normal(size=(n * d, 4)).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    mask = ell.edge_mask
    cases = [
        ("segment_sum", lambda a, m: ell_segment_sum(a, d, m),
         lambda a, m: jax_ell.ell_segment_sum(a, d, m), data),
        ("softmax", lambda a, m: ell_softmax(a, d, m),
         lambda a, m: jax_ell.ell_softmax(a, d, m), scores),
        ("repeat", lambda a, m: ell_repeat(a, d), lambda a, m: jax_ell.ell_repeat(a, d), x),
    ]
    for name, ours_fn, jax_fn, a in cases:
        at = _tensor(a).requires_grad_(True)
        got = ours_fn(at, _tensor(mask))
        want, vjp = jax.vjp(lambda v: jax_fn(v, jnp.asarray(mask)), jnp.asarray(a))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=1e-6,
                                   err_msg=name)
        g = rng.normal(size=got.shape).astype(np.float32)
        got.backward(_tensor(g))
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_ell_gather_forward_and_twin_backward():
    graphs = [pad_graph_ell_np(**_raw(n=24, seed=s), n_pad=24, degree=12) for s in (2, 8)]
    batch = concat_graphs(graphs)  # the twin slots of the second graph are offset
    d = batch.ell_degree
    rng = np.random.default_rng(3)
    x = rng.normal(size=(batch.num_nodes, 8)).astype(np.float32)
    w = rng.normal(size=(batch.num_edges, 8)).astype(np.float32)
    senders, twin = _tensor(batch.senders), _tensor(batch.twin_perm)
    xt = _tensor(x).requires_grad_(True)
    out = ell_gather(xt, senders, twin, d)
    assert torch.equal(out, _tensor(x)[senders.long()])
    (out * _tensor(w)).sum().backward()
    want = jax.grad(lambda v: (jax_ell.ell_gather(v, jnp.asarray(batch.senders),
                                                  jnp.asarray(batch.twin_perm), d)
                               * jnp.asarray(w)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the true gradient of x[senders]: a scatter of w into the senders
    true = torch.zeros_like(xt).index_add_(0, senders.long(), _tensor(w))
    np.testing.assert_allclose(xt.grad.numpy(), true.numpy(), rtol=RTOL, atol=ATOL)
    xd = _tensor(x).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: ell_gather(v, senders, twin, d), (xd,))


# ------------------------------------------------------------------ layers


def _block_inputs(seed, h, project_before_gather=False):
    raw = _raw(n=48, seed=seed)
    ell = pad_graph_ell_np(**raw, n_pad=48, degree=16)
    srt = pad_graph_sorted_np(**raw, n_pad=48, e_pad=48 * 16)
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(size=(48, h)).astype(np.float32)
    ea_real = rng.normal(size=(len(raw["senders"]), h)).astype(np.float32)
    # the same real edges: ELL slots and receiver-sorted rows both order
    # them by a stable sort on the receiver
    ea_ell = np.zeros((48 * 16, h), np.float32)
    ea_ell[ell.edge_mask] = ea_real[np.argsort(raw["receivers"], kind="stable")]
    ea_srt = np.zeros((48 * 16, h), np.float32)
    ea_srt[: len(ea_real)] = ea_real[np.argsort(raw["receivers"], kind="stable")]
    return ell, srt, x, ea_ell, ea_srt


def _port_block_grads(block, x, ea, g, ell):
    xt, et = _tensor(x).requires_grad_(True), _tensor(ea).requires_grad_(True)
    args = (_tensor(g.senders), _tensor(g.receivers), _tensor(g.edge_mask))
    if ell:
        out = block(xt, et, *args, None, g.ell_degree, _tensor(g.twin_perm))
    else:
        out = block(xt, et, *args, _tensor(g.row_bounds))
    emask = _tensor(g.edge_mask)[:, None]
    loss = (out[0] ** 2).sum() + ((out[1] * emask) ** 2).sum()
    loss.backward()
    return out, xt.grad, et.grad, {k: p.grad for k, p in block.named_parameters()}


@pytest.mark.parametrize("project_before_gather", [False, True])
def test_graphnet_block_ell_matches_jax_and_the_sorted_layout(project_before_gather):
    h = 16
    ell, srt, x, ea_ell, ea_srt = _block_inputs(5, h)
    jblock = jax_layers.GraphNetBlock(hidden_size=h, project_before_gather=project_before_gather)
    jargs = (jnp.asarray(ell.senders), jnp.asarray(ell.receivers), jnp.asarray(ell.edge_mask),
             ell.ell_degree, jnp.asarray(ell.twin_perm))
    params = jblock.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ea_ell), *jargs)["params"]
    emask = jnp.asarray(ell.edge_mask)[:, None]

    def jloss(p, xv, ev):
        a, b = jblock.apply({"params": p}, xv, ev, *jargs)
        return (a ** 2).sum() + ((b * emask) ** 2).sum(), (a, b)

    (_, (want_x, want_e)), (gp, gx, ge) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(ea_ell))
    sd = state_dict_under("processor_list.0", {"block_0": params})
    ours = GraphNetBlock(h, project_before_gather=project_before_gather)
    ours.load_state_dict(sd, strict=True)
    (got_x, got_e), got_gx, got_ge, got_gp = _port_block_grads(ours, x, ea_ell, ell, True)
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_e.detach().numpy()[ell.edge_mask],
                               np.asarray(want_e)[ell.edge_mask], rtol=RTOL, atol=ATOL)
    _close_grads(got_gx, gx)
    _close_grads(got_ge, ge)
    want_gp = state_dict_under("processor_list.0", {"block_0": gp})
    for name, g in got_gp.items():
        _close_grads(g, want_gp[name], name)
    # the port's own receiver-sorted layout on the same graph and weights
    plain = GraphNetBlock(h)
    plain.load_state_dict(sd, strict=True)
    (srt_x, srt_e), srt_gx, _, srt_gp = _port_block_grads(plain, x, ea_srt, srt, False)
    real = int(srt.edge_mask.sum())
    np.testing.assert_allclose(got_x.detach().numpy(), srt_x.detach().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_e.detach().numpy()[ell.edge_mask], srt_e.detach().numpy()[:real],
                               rtol=RTOL, atol=ATOL)
    _close_grads(got_gx, srt_gx)
    for name, g in got_gp.items():
        _close_grads(g, srt_gp[name], name)


def test_attention_ell_matches_jax_and_the_csr_layout():
    dim = 16
    raw = _raw(n=64, seed=4)
    ell = pad_graph_ell_np(**raw, n_pad=128, degree=16)
    csr = pad_graph_csr_np(**{**raw, "edge_attr": None}, n_pad=128, e_pad=64 * 16)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, dim)).astype(np.float32)
    jattn = jax_layers.Attention(output_dim=dim, num_heads=4)
    jargs = (jnp.asarray(ell.senders), jnp.asarray(ell.receivers), jnp.asarray(ell.edge_mask),
             ell.ell_degree, jnp.asarray(ell.twin_perm))
    params = jattn.init(jax.random.key(0), jnp.asarray(x), *jargs)["params"]
    want, vjp = jax.vjp(lambda v: jattn.apply({"params": params}, v, *jargs), jnp.asarray(x))
    ours = Attention(dim, 4)
    ours.load_state_dict(_attention_state_dict(params), strict=True)
    g = rng.normal(size=(128, dim)).astype(np.float32)
    real = ell.node_mask
    outs = {}
    for name, graph, extra in (
        ("ell", ell, dict(ell_degree=ell.ell_degree, twin_perm=_tensor(ell.twin_perm))),
        ("csr", csr, dict(sender_bounds=_tensor(csr.sender_bounds))),
    ):
        xt = _tensor(x).requires_grad_(True)
        out = ours(xt, _tensor(graph.senders), _tensor(graph.receivers), _tensor(graph.edge_mask),
                   **extra)
        out.backward(_tensor(g))
        outs[name] = (out.detach().numpy(), xt.grad.numpy())
    np.testing.assert_allclose(outs["ell"][0][real], np.asarray(want)[real], rtol=RTOL, atol=ATOL)
    _close_grads(outs["ell"][1], vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(outs["ell"][0][real], outs["csr"][0][real], rtol=RTOL, atol=ATOL)
    _close_grads(outs["ell"][1], outs["csr"][1])


# ----------------------------------------------------------------- dataset


def test_ell_degree_budget_canonical_across_first_touched_index(tmp_path):
    meta = str(tmp_path / "meta.json")
    with open(meta, "w") as f:
        json.dump({"trajectory_length": 3}, f)

    class Toy(BaseDataset):
        @property
        def size_dataset(self):
            return 2

        def _load(self, index):
            traj = index // self.frames_per_trajectory
            deg = 4 if traj == 0 else 8  # the trajectories' largest in-degrees differ
            s, r = to_undirected(np.zeros(deg, np.int32), np.arange(1, deg + 1, dtype=np.int32))
            return RawSample(x=np.ones((12, 1), np.float32), pos=np.zeros((12, 2), np.float32),
                             senders=s, receivers=r, y=np.zeros((12, 1), np.float32),
                             traj_index=traj)

    ds_a = Toy(meta_path=meta, edge_layout="ell", add_edge_features=False)
    ds_b = Toy(meta_path=meta, edge_layout="ell", add_edge_features=False)
    ds_a[0]  # one process pads the low-degree trajectory first
    ds_b[2]  # another the high-degree one
    ds_a[2]
    ds_b[0]
    assert ds_a.ell_degree == ds_b.ell_degree == 8  # 4 + 4 slots of headroom
    assert ds_a[2].senders.shape == ds_b[2].senders.shape


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    d = tmp_path_factory.mktemp("cyl_ell")  # the name must not contain "train"
    return write_cylinder_h5(str(d), num_traj=2, steps=6, nx=8, ny=6)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_ell_items_match_jax(cylinder, kind):
    param = cylinder_param(*cylinder, kind)
    edges = kind == "epd"
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges),
                                use_edge_feature=edges, edge_layout="ell")
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges), use_edge_feature=edges,
                     edge_layout="ell")
    for i in (0, 3, 7):
        a, b = ds[i], jax_ds[i]
        assert a.ell_degree == b.ell_degree and ds.ell_degree == jax_ds.ell_degree
        for field in ("x", "senders", "receivers", "edge_attr", "node_mask", "edge_mask", "y",
                      "twin_perm"):
            va, vb = getattr(a, field), getattr(b, field)
            assert (va is None) == (vb is None), field
            if va is not None:
                assert np.array_equal(va, np.asarray(vb)), (i, field)


# ----------------------------------------------------------------- training


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_ten_ell_train_steps_match_the_jax_trainer(cylinder, kind):
    param = cylinder_param(*cylinder, kind, hidden=32)
    param["dataset"]["edge_layout"] = "ell"
    edges = kind == "epd"
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges),
                                use_edge_feature=edges)
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges), use_edge_feature=edges)
    assert ds.edge_layout == jax_ds.edge_layout == "ell"
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0)
    loader = GraphLoader(ds, batch_size=2, shuffle=True)
    jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, metrics_path=None, rollout_dir=None)
    jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
    trainer = Trainer(param, learning_rate=1e-3, warmup=3, device="cpu")
    trainer.init_state(10)
    state = jax_trainer.state
    load_reference_checkpoint(trainer.sim, export_reference_checkpoint(
        {"params": state["params"], "normalizer": state["normalizer"]}))
    before = _launches()
    losses, jax_losses = [], []
    for epoch in range(2):  # 5 batches of 2 frames an epoch
        jax_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        for jb, b in zip(jax_loader, loader):
            assert b.ell_degree == jb.ell_degree
            jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
            jax_losses.append(float(jloss))
            losses.append(trainer.train_step(b).item())
    assert len(losses) == 10 and _launches() == before  # the ELL path runs no kernel
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_RTOL)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_remat_on_the_ell_layout_is_bitwise_and_matches_jax(kind):
    """Twin of ``test_remat.py::test_epd_remat_ell_layout`` and its
    transformer sibling: ``ell_degree`` rides through the checkpointed
    blocks, remat gives the plain blocks' output and gradients bit for bit,
    and the model's output is the JAX ELL model's."""
    raw = _raw(n=100, seed=2)
    raw["x"] = np.random.default_rng(9).normal(size=(100, 11)).astype(np.float32)
    raw.pop("node_type_index")
    if kind == "transformer":
        raw["edge_attr"] = None
    g = pad_graph_ell_np(**raw, n_pad=128, degree=32)
    model = {"type": kind, "message_passing_num": 3, "hidden_size": 16, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3 if kind == "epd" else 0, "num_heads": 4}
    base = get_model({"model": model})
    reset_parameters(base, torch.Generator().manual_seed(0))
    rem = get_model({"model": {**model, "remat": True}})
    rem.load_state_dict(base.state_dict(), strict=True)
    gt = g.to("cpu")
    results = []
    for m in (base, rem):
        out = m(gt)
        mask = gt.node_mask.to(torch.float32)[:, None]
        ((out ** 2 * mask).sum() / mask.sum()).backward()
        results.append((out.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}))
    assert torch.equal(results[0][0], results[1][0])
    for name, grad in results[0][1].items():
        assert torch.equal(grad, results[1][1][name]), name
    jmodel = jax_pp.get_model({"model": {**model, "remat": True}})
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a,
                                jax_graph.pad_graph_ell_np(**raw, n_pad=128, degree=32))
    params = jmodel.init(jax.random.key(0), jg)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jg))
    sd = {k[len("model."):]: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_reference_state_dict({"model": params}).items()}
    base.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = base(gt).numpy()
    real = g.node_mask
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
