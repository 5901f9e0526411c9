"""Port parity, training: the losses, the schedule, AdamW against optax's
``adamw``, the Simulator's training branch against
``sim.apply(..., is_training=True, mutable=["normalizer"])``, and 10 train
steps of the port's ``Trainer`` against the JAX ``Trainer`` from equal
weights (JAX ``init_state`` -> ``export_reference_checkpoint`` ->
``load_reference_checkpoint``) on equal batches from the two packages'
datasets and loaders, for EncodeProcessDecode (receiver-sorted batches) and
EncodeTransformDecode (sender-sorted CSR batches, the JAX Pallas kernel in
interpret mode). Also a ``fit`` run on the fixture. Everything runs on the
CPU."""

import contextlib
import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.training import losses as jax_losses
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.schedule import cosine_warmup_schedule as jax_schedule
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.synthetic import write_cylinder_h5
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core.graph import pad_graph_csr_np, pad_graph_sorted_np
from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.ops.csr_attention import csr_softmax_spmm, csr_softmax_spmm_backward
from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward
from graphphysics_torch.training import (
    Trainer,
    cosine_warmup_schedule,
    get_dataset,
    get_preprocessing,
    get_simulator,
    l1_smooth_loss,
    l2_loss,
    make_local_loss,
    node_type_mask,
)
from graphphysics_torch.training.trainer import BETAS, EPS, WEIGHT_DECAY
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# losses: f32 means in another order
LOSS_RTOL = 1e-6
# step losses over 10 steps: f32 forward and backward in another order
# (XLA vs ATen), then AdamW's normalized updates
STEP_RTOL = 2e-5
# parameters after 10 steps of at most lr = 1e-3 each: a few ulps of the
# gradients move an Adam update by up to that much relative to lr
PARAM_ATOL = 2e-4
# the key bias's gradient (0 in exact arithmetic) against the largest of the
# other leaves' in any of the 10 steps: f32 round-off of a sum of cancelling
# terms, at most 3.3e-8 on this fixture
KBIAS_GRAD_SHARE = 1e-6
# the most one AdamW step moves a leaf, in units of its learning rate: with
# beta1**2 < beta2, |m_hat / sqrt(v_hat)| <= 1.17 (Cauchy-Schwarz over the
# moment sums), plus a decay step of lr * 1e-4 * |p|
ADAM_STEP_MAX = 1.2
KERNELS = (csr_segment_sum, csr_segment_sum_backward, csr_softmax_spmm, csr_softmax_spmm_backward)


def _launches():
    return tuple(k.launches for k in KERNELS)


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    # the directory name must not contain "train" (switch_to_val)
    d = tmp_path_factory.mktemp("cyl_port")
    h5_path, meta_path = write_cylinder_h5(str(d), num_traj=2, steps=6, nx=8, ny=6)
    return h5_path, meta_path


def _param(h5_path, meta_path, kind):
    model = {"type": "epd", "message_passing_num": 2, "hidden_size": 32, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3}
    if kind == "transformer":
        model = {"type": "transformer", "message_passing_num": 2, "hidden_size": 32,
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


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("empty", [False, True])
def test_losses_match_jax(empty):
    r = np.random.default_rng(0)
    n = 40
    target = r.normal(size=(n, 3)).astype(np.float32)
    out = (2 * r.normal(size=(n, 3))).astype(np.float32)
    node_type = r.integers(0, 7, n).astype(np.int32)
    valid = r.random(n) > 0.2
    exclude = r.random(n) > 0.8
    masks = [9] if empty else [0, 5]  # no node has type 9
    j = [jnp.asarray(a) for a in (target, out, node_type, valid, exclude)]
    t = [torch.from_numpy(a) for a in (target, out, node_type, valid, exclude)]
    np.testing.assert_array_equal(
        node_type_mask(t[2], masks, t[3], t[4]).numpy(),
        np.asarray(jax_losses.node_type_mask(j[2], masks, j[3], j[4])),
    )
    for ours, theirs in (
        (l2_loss(t[0], t[1], t[2], masks, node_valid=t[3], exclude_mask=t[4]),
         jax_losses.l2_loss(j[0], j[1], j[2], masks, node_valid=j[3], exclude_mask=j[4])),
        (l1_smooth_loss(t[0], t[1], t[2], masks, beta=0.7, node_valid=t[3], exclude_mask=t[4]),
         jax_losses.l1_smooth_loss(j[0], j[1], j[2], masks, beta=0.7, node_valid=j[3],
                                   exclude_mask=j[4])),
    ):
        np.testing.assert_allclose(ours.item(), float(theirs), rtol=LOSS_RTOL)
        if empty:
            assert ours.item() == 0.0
    local = make_local_loss(masks, "l2")(t[0], t[1], t[2], t[3], t[4])
    want = jax_losses.make_local_loss(masks, "l2")(j[0], j[1], j[2], j[3], j[4])
    for a, b in zip(local, want):
        np.testing.assert_allclose(a.item(), float(b), rtol=LOSS_RTOL)
    # the GMM kinds are held against JAX in tests/test_torch_port_gmm.py
    with pytest.raises(ValueError, match="nope"):
        make_local_loss(masks, "nope")


@pytest.mark.parametrize("warmup,max_iters", [(5, 20), (0, 7), (30, 10)])
def test_schedule_matches_jax_with_its_clamp(warmup, max_iters):
    ours = cosine_warmup_schedule(1e-3, warmup, max_iters)
    theirs = jax_schedule(1e-3, warmup, max_iters)
    steps = range(max_iters + 6)  # past max_iters: clamped, no ramp back up
    got = np.array([ours(s) for s in steps])
    # JAX computes the factor in f32, the port in Python floats
    np.testing.assert_allclose(got, [float(theirs(s)) for s in steps], rtol=1e-5)
    assert np.all(got[max_iters - 1:] == got[max_iters - 1])


def test_adamw_and_schedule_match_optax():
    """AdamW (decoupled decay on every leaf, eps outside the root, bias
    correction from step 1) under a LambdaLR of the schedule against
    ``optax.adamw(schedule)``, whose first update uses ``schedule(0)``."""
    r = np.random.default_rng(1)
    params = {"w": r.normal(size=(5, 3)).astype(np.float32), "b": r.normal(size=3).astype(np.float32)}
    grads = [{k: r.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    tx = optax.adamw(jax_schedule(1e-2, 3, 6), b1=0.9, b2=0.95, weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    assert (BETAS, EPS, WEIGHT_DECAY) == ((0.9, 0.95), 1e-8, 1e-4)  # the Trainer's AdamW
    opt = torch.optim.AdamW(tp.values(), lr=1.0, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_warmup_schedule(1e-2, 3, 6))
    for gr in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gr[k])
        opt.step()
        sched.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- simulator


def _jax_graph(g):
    return JaxGraph(
        x=jnp.asarray(g.x), pos=jnp.asarray(g.pos), senders=jnp.asarray(g.senders),
        receivers=jnp.asarray(g.receivers),
        edge_attr=None if g.edge_attr is None else jnp.asarray(g.edge_attr),
        node_mask=jnp.asarray(g.node_mask), edge_mask=jnp.asarray(g.edge_mask), y=jnp.asarray(g.y),
    )


def _random_graph(kind, seed, n=50, e=200):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    pad = pad_graph_sorted_np if kind == "epd" else pad_graph_csr_np
    return pad(
        x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), 128, 256,
        edge_attr=r.normal(size=(e, 3)).astype(np.float32) if kind == "epd" else None,
        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    )


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_simulator_training_branch_matches_jax(cylinder, kind):
    """Two training calls: each folds its batch into the normalizers first
    and normalizes with the updated statistics, padding masked out."""
    param = _param(*cylinder, kind)
    jax_sim = jax_pp.get_simulator(param)
    graphs = [_random_graph(kind, seed) for seed in (3, 4)]
    variables = jax_sim.init({"params": jax.random.key(0)}, _jax_graph(graphs[0]))
    sim = get_simulator(param, device="cpu")
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    for g in graphs:
        want, mutated = jax_sim.apply(variables, _jax_graph(g), is_training=True, mutable=["normalizer"])
        variables = {"params": variables["params"], "normalizer": mutated["normalizer"]}
        got = sim(g.to("cpu"), is_training=True)
        assert got[2] is None and want[2] is None
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
        stats = export_reference_checkpoint(variables)
        sd = sim.state_dict()
        for name in ("_output_normalizer", "_node_normalizer", "_edge_normalizer"):
            if stats.get(name) is None:
                continue
            for stat in ("_acc_count", "_num_accumulations", "_acc_sum", "_acc_sum_squared"):
                np.testing.assert_allclose(sd[f"{name}.{stat}"].numpy().ravel(),
                                           np.ravel(stats[name][stat]), rtol=1e-6, atol=1e-5)
    # eval does not accumulate unless asked
    before = sim._node_normalizer._acc_count.clone()
    with torch.no_grad():
        sim(graphs[0].to("cpu"))
    assert torch.equal(sim._node_normalizer._acc_count, before)


# ---------------------------------------------------------------- train steps


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_ten_train_steps_match_the_jax_trainer(cylinder, kind):
    param = _param(*cylinder, kind)
    edges = kind == "epd"
    jax_layout = {"edge_layout": "csr"} if kind == "transformer" else {}
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges),
                                use_edge_feature=edges, **jax_layout)
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges), use_edge_feature=edges)
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0)
    loader = GraphLoader(ds, batch_size=2, shuffle=True)
    # the CSR batches run the JAX Pallas kernel: interpret mode on the CPU
    interpret = pltpu.force_tpu_interpret_mode() if kind == "transformer" else contextlib.nullcontext()
    with interpret:
        jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, metrics_path=None,
                                 rollout_dir=None)
        jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
        trainer = Trainer(param, learning_rate=1e-3, warmup=3, device="cpu")
        trainer.init_state(10)
        state = jax_trainer.state
        load_reference_checkpoint(
            trainer.sim,
            export_reference_checkpoint({"params": state["params"], "normalizer": state["normalizer"]}),
        )
        # the key bias gets a zero gradient in exact arithmetic (the softmax
        # ignores a shift shared by a query's scores): on both sides its Adam
        # updates are driven by round-off, so it is checked apart
        kbias = [n for n, _ in trainer.sim.named_parameters() if n.endswith("k_proj.bias")]
        start = {k: trainer.sim.state_dict()[k].clone() for k in kbias}
        before = _launches()
        losses, jax_losses_, kbias_share = [], [], []
        for epoch in range(2):  # 5 batches of 2 frames an epoch
            jax_loader.set_epoch(epoch)
            loader.set_epoch(epoch)
            for jb, b in zip(jax_loader, loader):
                jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
                jax_losses_.append(float(jloss))
                losses.append(trainer.train_step(b).item())
                grads = {n: p.grad.abs().max().item() for n, p in trainer.sim.named_parameters()}
                if kbias:
                    kbias_share.append(max(grads[k] for k in kbias)
                                       / max(g for n, g in grads.items() if n not in kbias))
    assert len(losses) == 10 and trainer.step == 10 and _launches() == before
    np.testing.assert_allclose(losses, jax_losses_, rtol=STEP_RTOL)
    assert bool(kbias) == (kind == "transformer")
    assert all(share < KBIAS_GRAD_SHARE for share in kbias_share), kbias_share
    state = jax_trainer.state
    want = export_reference_checkpoint({"params": state["params"], "normalizer": state["normalizer"]})
    sd = trainer.sim.state_dict()
    lr_sum = sum(trainer.schedule(i) for i in range(10))
    for key, value in want["model"].items():
        got, theirs = sd[key].numpy(), np.asarray(value, np.float32).reshape(sd[key].shape)
        if key in kbias:
            for side in (got, theirs):
                moved = np.abs(side - start[key].numpy()).max()
                assert moved <= ADAM_STEP_MAX * lr_sum, (key, moved)
            continue
        np.testing.assert_allclose(got, theirs, rtol=0, atol=PARAM_ATOL, err_msg=key)
    for name in ("_output_normalizer", "_node_normalizer"):
        np.testing.assert_allclose(sd[f"{name}._acc_sum"].numpy().ravel(),
                                   np.ravel(want[name]["_acc_sum"]), rtol=1e-6, atol=1e-5)
        assert sd[f"{name}._acc_count"].item() == float(np.ravel(want[name]["_acc_count"])[0])


def test_fit_lowers_the_loss_and_validates(cylinder, tmp_path):
    # without the training noise, whose share of the tiny per-frame deltas
    # of the fixture keeps a 10-step run from learning much
    param = _param(*cylinder, "epd")
    ds = get_dataset(param, get_preprocessing(param, remove_noise=True))
    val = get_dataset(param, get_preprocessing(param, remove_noise=True))
    loader = GraphLoader(ds, batch_size=2, shuffle=True)
    metrics = tmp_path / "metrics.csv"
    trainer = Trainer(param, learning_rate=1e-2, warmup=3, log_every=5, metrics_path=str(metrics),
                      checkpoint_dir=str(tmp_path / "ckpt"), rollout_dir=None, device="cpu")
    before = _launches()
    history = trainer.fit(loader, val_dataset=val, num_epochs=2, val_trajectories=1)
    assert _launches() == before  # the CPU takes the plain versions
    assert len(history["train_loss"]) == 2 and trainer.step == 2 * len(loader)
    assert history["train_loss"][1] < history["train_loss"][0]
    assert all(np.isfinite(v) and v > 0 for v in history["val_rmse"])
    with open(metrics, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows if r["train_loss"]] == [5, 10]
    assert float(rows[-1]["val_all_rollout_rmse"]) == history["val_rmse"][-1]


def test_trainer_refuses_what_is_not_ported(cylinder):
    param = _param(*cylinder, "epd")
    # data parallelism is ported: it needs the ranks of a process group
    with pytest.raises(RuntimeError, match="no process group for data_parallel"):
        Trainer(param, data_parallel=True, device="cpu")
    assert Trainer(param, parallel_validation=True, device="cpu").parallel_validation
    with pytest.raises(TypeError, match="no_such_option"):
        Trainer(param, no_such_option=1, device="cpu")
    Trainer(param, data_parallel=False, graph_partition=0, device="cpu")  # off is fine
    with pytest.raises(RuntimeError, match="init_state"):
        Trainer(param, device="cpu").train_step(_random_graph("epd", 0))
