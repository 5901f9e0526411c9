"""Port parity, gradient accumulation (``training/microbatch.py``): the
microbatch step on a stacked ``[M, ...]`` batch against the plain step on
the concatenation (loss, parameters, normalizer statistics and the
once-per-step counter), the accumulation cap, both GMM NLLs, ``fit`` with
``gradient_accumulation`` (twins of ``tests/test_microbatch.py``); 10 steps
of the port's ``Trainer(gradient_accumulation=True)`` against the JAX
``Trainer``'s on the same stacked batches, for the L2 loss and both GMM
heads; a mid-epoch resume under gradient accumulation, bitwise. Everything
runs on the CPU."""

import copy

import jax
import numpy as np
import pytest
import torch

from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core.graph import concat_graphs, pad_graph_sorted_np, stack_graphs
from graphphysics_torch.core.normalizer import MAX_ACCUMULATIONS
from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.models.simulator import Normalizer
from graphphysics_torch.training import (
    Trainer,
    get_dataset,
    get_preprocessing,
    load_metadata,
    make_local_loss,
)
from graphphysics_torch.training.microbatch import gmm_kwargs, loss_kind, microbatch_step
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import cylinder_param, write_cylinder_split

MASKS = (0, 5)  # NodeType.NORMAL, NodeType.OUTFLOW
# the step on M microbatches against the concat step: f32 sums of the loss
# and the gradients in another order, as tests/test_microbatch.py's limits
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-6
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
# 10 steps against the JAX Trainer, as tests/test_torch_port_training.py
STEP_RTOL = 2e-5


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_micro"))


def _graphs(m=4, n_pad=64, e_pad=256):
    """``m`` receiver-sorted graphs of one padded shape and different real
    node counts, so the microbatches weigh differently in the mean."""
    graphs = []
    for seed in range(m):
        r = np.random.default_rng(seed)
        n, e = 40 + 6 * seed, 150 + 20 * seed
        x = r.normal(size=(n, 4)).astype(np.float32)
        x[:, 2] = r.choice([0, 5, 6], n)
        graphs.append(pad_graph_sorted_np(
            x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
            r.integers(0, n, e).astype(np.int32), n_pad, e_pad,
            edge_attr=r.normal(size=(e, 3)).astype(np.float32),
            y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2))
    return graphs


def _trainer(cylinder, **model):
    param = cylinder_param(*cylinder, "epd", blocks=1, hidden=8)
    param["model"].update(model)
    trainer = Trainer(param, learning_rate=1e-3, warmup=0, device="cpu")
    trainer.init_state(10)
    return trainer


def _stats(sim):
    return {k: v.clone() for k, v in sim.state_dict().items() if "_normalizer" in k}


@pytest.mark.parametrize("head", ["l2", "diag_gmm", "full_gmm"])
def test_microbatch_step_matches_the_concat_step(cylinder, head):
    model = {} if head == "l2" else {"num_mixture_components": 2, "temperature": 1.0,
                                     "use_diagonal": head == "diag_gmm"}
    base, accum = _trainer(cylinder, **model), _trainer(cylinder, **model)  # equal weights
    accum.gradient_accumulation = True
    graphs = _graphs()
    want = base.train_step(concat_graphs(graphs)).item()
    got = accum.train_step(stack_graphs(graphs)).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for (name, a), b in zip(accum.sim.named_parameters(), base.sim.parameters()):
        torch.testing.assert_close(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=name)
    sa, sb = _stats(accum.sim), _stats(base.sim)
    for key in sa:
        if key.endswith(("_acc_count", "_num_accumulations")):
            assert torch.equal(sa[key], sb[key]), key
        else:
            torch.testing.assert_close(sa[key], sb[key], rtol=STATS_RTOL, atol=STATS_ATOL, msg=key)


def test_microbatch_counter_advances_once_per_step(cylinder):
    trainer = _trainer(cylinder)
    trainer.gradient_accumulation = True
    batch = stack_graphs(_graphs())
    losses = [trainer.train_step(batch).item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for m in trainer.sim.modules():
        if isinstance(m, Normalizer):
            assert m._num_accumulations.item() == 3.0  # not 3 * M


def test_microbatch_respects_accumulation_cap(cylinder):
    trainer = _trainer(cylinder)
    trainer.gradient_accumulation = True
    for m in trainer.sim.modules():
        if isinstance(m, Normalizer):
            m._num_accumulations.fill_(float(MAX_ACCUMULATIONS))
    before = _stats(trainer.sim)
    assert np.isfinite(trainer.train_step(stack_graphs(_graphs())).item())
    after = _stats(trainer.sim)
    for key in before:
        assert torch.equal(before[key], after[key]), key


def test_microbatch_step_divides_once_by_the_total_count(cylinder):
    """The gradients are the concatenation's mean, not the mean of the
    microbatches' means (the node counts of ``_graphs`` differ)."""
    trainer = _trainer(cylinder)
    graphs = _graphs()
    local = make_local_loss(MASKS, "l2")
    batch = stack_graphs(graphs).to("cpu")
    sim = copy.deepcopy(trainer.sim)
    microbatch_step(sim, torch.optim.SGD(sim.parameters(), lr=0.0), batch, local)
    got = {n: p.grad.clone() for n, p in sim.named_parameters()}
    means = []
    for i in range(len(graphs)):
        s2 = copy.deepcopy(trainer.sim)
        s2.load_state_dict(sim.state_dict())  # the merged statistics
        out, target, _ = s2(batch[i], is_training=True, accumulate_stats=False)
        ls, c = local(target, out, s2.node_type(batch[i]), batch[i].node_mask, None)
        (ls / c).backward()
        means.append({n: p.grad for n, p in s2.named_parameters()})
    name = "model.decode_module.6.bias"
    mean_of_means = sum(m[name] for m in means) / len(means)
    assert not torch.allclose(got[name], mean_of_means, rtol=1e-3)


def test_trainer_gradient_accumulation_fit(cylinder, tmp_path):
    param = cylinder_param(*cylinder, "epd", blocks=1, hidden=8)
    ds = get_dataset(param, get_preprocessing(param))
    loader = GraphLoader(ds, batch_size=2, shuffle=True, collate="stack")
    trainer = Trainer(param, learning_rate=1e-3, warmup=2, gradient_accumulation=True,
                      checkpoint_dir=str(tmp_path / "ckpt"), metrics_path=None, rollout_dir=None,
                      log_every=100, device="cpu")
    history = trainer.fit(loader, num_epochs=3)
    assert history["train_loss"][-1] < history["train_loss"][0]
    with pytest.raises(ValueError, match="stacked"):
        trainer.train_step(concat_graphs([ds[0], ds[1]]))


@pytest.mark.parametrize("head", ["l2", "diag_gmm", "full_gmm"])
def test_ten_accumulation_steps_match_the_jax_trainer(cylinder, head):
    param = cylinder_param(*cylinder, "epd", blocks=1, hidden=16)
    if head != "l2":
        param["model"].update({"num_mixture_components": 2, "temperature": 1.0,
                               "use_diagonal": head == "diag_gmm"})
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param))
    ds = get_dataset(param, get_preprocessing(param))
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0, collate="stack")
    loader = GraphLoader(ds, batch_size=2, shuffle=True, collate="stack")
    jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, gradient_accumulation=True,
                             metrics_path=None, rollout_dir=None)
    jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
    trainer = Trainer(param, learning_rate=1e-3, warmup=3, gradient_accumulation=True, device="cpu")
    trainer.init_state(10)
    assert loss_kind(trainer.K, trainer.use_diagonal) == head
    state = jax_trainer.state
    load_reference_checkpoint(trainer.sim, export_reference_checkpoint(
        {"params": state["params"], "normalizer": state["normalizer"]}))
    losses, jax_losses = [], []
    for epoch in range(2):  # 5 stacked batches of 2 microbatches an epoch
        jax_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        for jb, b in zip(jax_loader, loader):
            assert b.x.shape == jb.x.shape and b.x.ndim == 3
            jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
            jax_losses.append(float(jloss))
            losses.append(trainer.train_step(b).item())
    assert len(losses) == 10
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_RTOL)
    want = export_reference_checkpoint(
        {"params": jax_trainer.state["params"], "normalizer": jax_trainer.state["normalizer"]})
    for name in ("_output_normalizer", "_node_normalizer", "_edge_normalizer"):
        sd = trainer.sim.state_dict()
        assert sd[f"{name}._num_accumulations"].item() == float(
            np.ravel(want[name]["_num_accumulations"])[0]) == 10.0
        assert sd[f"{name}._acc_count"].item() == float(np.ravel(want[name]["_acc_count"])[0])
    assert gmm_kwargs(0, 2, 1.0) == {}


def test_accumulation_resume_mid_epoch_is_bitwise(cylinder, tmp_path):
    param = cylinder_param(*cylinder, "epd", blocks=1, hidden=8)

    def run(directory, stop_after=None, resume=None):
        ds = get_dataset(param, get_preprocessing(param))
        loader = GraphLoader(ds, batch_size=2, shuffle=True, collate="stack")
        trainer = Trainer(param, learning_rate=1e-3, warmup=2, gradient_accumulation=True,
                          checkpoint_dir=str(directory), metrics_path=None, rollout_dir=None,
                          log_every=100, device="cpu")

        class Stop:
            def __len__(self):
                return len(loader)

            def set_epoch(self, epoch):
                loader.set_epoch(epoch)

            def set_start_batch(self, batch):
                loader.set_start_batch(batch)

            def __iter__(self):
                for i, batch in enumerate(loader):
                    if stop_after is not None and i == stop_after - 1:
                        trainer.request_interrupt()
                    yield batch

        history = trainer.fit(Stop(), num_epochs=2, resume_from=resume)
        return trainer, history

    full, history_full = run(tmp_path / "a")
    part, history_part = run(tmp_path / "b", stop_after=3)
    assert history_part["interrupted"] and part.step == 3
    ckpt = str(tmp_path / "b" / "state.pt")
    assert load_metadata(ckpt)["batch_offset"] == 3
    resumed, history_resumed = run(tmp_path / "b", resume=ckpt)
    assert resumed.step == full.step == 2 * 5
    for (name, a), b in zip(full.sim.state_dict().items(), resumed.sim.state_dict().values()):
        assert torch.equal(a, b), name
    assert history_resumed["train_loss"] == history_full["train_loss"]
