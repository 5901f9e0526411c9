"""Port parity, bf16 compute (``"precision": "bf16"``): the port's
``get_model`` against the JAX ``get_model`` for EncodeProcessDecode, the
transformer on its CSR layout and the transformer with a K = 3 diagonal GMM
head, from equal weights (``export_reference_state_dict``,
``load_state_dict(strict=True)``): the eval forward, each parameter's
gradient of one step's loss, the dtypes at the seams, and 10 ``Trainer``
steps against the JAX ``Trainer``. The f32 port held against the same bf16
JAX model fails the same tolerances: the bf16 port rounds where JAX rounds.
The JAX transformer runs its CSR attention (K2) in TPU interpret mode.
Everything runs on the CPU; inputs come from numpy with a seed."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint, export_reference_state_dict
from graphphysics_torch.core import graph as port_graph
from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.training import Trainer, get_dataset, get_model, get_preprocessing
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import cylinder_param, write_cylinder_split

# The eval forward, max |port - JAX| over max |JAX| on the real nodes. The
# port's bf16 ops round where XLA's do (each op's output, a Dense's product
# and then its sum with the bias, the constants first), so most outputs
# agree to the bit; a rounding that falls the other way on one side (a sum
# taken in another order) then moves its row by a bf16 ulp, 3 blocks deep.
# bf16 port vs bf16 JAX read 0 to 4.4e-3 over these graphs and two seeds;
# the f32 port against the same bf16 JAX model 1.1e-2 to 2.9e-2.
FWD_RTOL = 8e-3
# Each parameter's gradient, ||port - JAX|| / ||JAX||, the worst parameter:
# the backward's bf16 roundings on top of the forward's. bf16 port vs bf16
# JAX read 6.5e-3 to 9.2e-3; the f32 port 2.8e-2 to 0.18.
GRAD_RTOL = 1.5e-2
# 10 train steps' losses: the gradients' bf16 round-off through AdamW's
# normalized steps. The bf16 port read at most 4.8e-3 (EPD) and 1.1e-2
# (transformer) off the bf16 JAX Trainer. A mean loss does not tell the two
# precisions apart (the f32 port read 2.4e-3 and 7.3e-3 off the same bf16
# JAX Trainer): the model test above is the one that discriminates.
STEP_RTOL = 2e-2
KINDS = {
    "epd": ("epd", 0),
    "transformer": ("transformer", 0),
    "transformer_gmm": ("transformer", 3),
}


def _param(kind, precision, K=0, hidden=32, blocks=3):
    model = {"type": kind, "message_passing_num": blocks, "hidden_size": hidden,
             "node_input_size": 2, "output_size": 3, "edge_input_size": 3 if kind == "epd" else 0,
             "num_heads": 4, "precision": precision}
    if K:
        model.update(num_mixture_components=K, temperature=1.0)
    return {"model": model}


def _graphs(kind, seed=0, n=100, e=600, n_pad=128, e_pad=768):
    """The same raw graph padded by the JAX and the port padding (COO and
    receiver-sorted for EPD, sender-sorted CSR for the transformer), with
    the model's full input width as node features."""
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


def _jax_reference(kind, K, jg, seed=0):
    """The bf16 JAX model's params, eval output and loss gradients."""
    model = jax_pp.get_model(_param(kind, "bf16", K))
    mask = jg.node_mask[:, None]

    def loss(p):
        out = model.apply({"params": p}, jg)
        return (out ** 2 * mask).sum() / mask.sum()

    with pltpu.force_tpu_interpret_mode():
        params = model.init(jax.random.key(seed), jg)["params"]
        # nonzero biases (flax starts them at 0): a bf16 Dense rounds its
        # product, then its sum with the bias
        r = np.random.default_rng(seed)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(0.1 * r.normal(size=a.shape), a.dtype)
            if path[-1].key == "bias" else a, params)
        out = model.apply({"params": params}, jg)
        grads = jax.grad(loss)(params)
    assert out.dtype == jnp.float32
    return params, np.asarray(out), export_reference_state_dict({"model": grads})


def _port_run(kind, K, precision, params, g, seams=None):
    """The port model at ``precision`` with the JAX weights: eval output and
    the gradient of each parameter; ``seams`` (a dict) collects the dtypes
    at the model's seams."""
    model = get_model(_param(kind, precision, K))
    state = {k[len("model."):]: torch.from_numpy(np.array(v, np.float32))
             for k, v in export_reference_state_dict({"model": params}).items()}
    model.load_state_dict(state, strict=True)
    hooks = []
    if seams is not None:
        def record(name):
            def hook(module, inputs, output):
                seams.setdefault(name, set()).add(
                    (inputs[0].dtype, output.dtype if torch.is_tensor(output) else output[0].dtype))
            return hook
        for name, module in model.named_modules():
            if name.endswith(("q_proj", "k_proj", "v_proj", "edge_block", "node_block")):
                hooks.append(module.register_forward_hook(record(name.split(".")[-1])))
            elif name in ("decode_module", "processor_list.0", "nodes_encoder"):
                hooks.append(module.register_forward_hook(record(name)))
    out = model(g)
    for h in hooks:
        h.remove()
    mask = g.node_mask.to(torch.float32)[:, None]
    ((out ** 2 * mask).sum() / mask.sum()).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return model, out.detach(), grads


def _errors(want_out, want_grads, out, grads, node_mask):
    real = np.asarray(node_mask)
    fwd = np.abs(out.numpy()[real] - want_out[real]).max() / np.abs(want_out[real]).max()
    rel = {}
    for key, value in want_grads.items():
        name = key[len("model."):]
        if name.endswith("k_proj.bias"):  # 0 in exact arithmetic: round-off on both sides
            continue
        theirs = np.asarray(value, np.float32).reshape(grads[name].shape)
        rel[name] = np.linalg.norm(grads[name].numpy() - theirs) / np.linalg.norm(theirs)
    worst = max(rel, key=rel.get)
    return fwd, rel[worst], worst


@pytest.mark.parametrize("case", list(KINDS))
def test_bf16_model_matches_jax_and_f32_does_not(case):
    kind, K = KINDS[case]
    jg, g = _graphs(kind)
    params, want_out, want_grads = _jax_reference(kind, K, jg)

    seams = {}
    model, out, grads = _port_run(kind, K, "bf16", params, g, seams)
    fwd, grad, worst = _errors(want_out, want_grads, out, grads, g.node_mask)
    assert fwd <= FWD_RTOL, f"bf16 forward rel err {fwd}"
    assert grad <= GRAD_RTOL, f"bf16 gradient rel err {grad} ({worst})"

    # the dtypes at the seams: f32 streams in and out of the blocks, bf16
    # projections (q, k, v reach the attention in bf16), f32 messages into
    # the EPD's segment sum, the decoder's own output in bf16 (the model
    # casts it: f32 predictions, as JAX), f32 parameters and gradients
    bf16, f32 = torch.bfloat16, torch.float32
    assert seams["nodes_encoder"] == {(f32, f32)}
    assert seams["processor_list.0"] == {(f32, f32)}
    if kind == "transformer":
        for name in ("q_proj", "k_proj", "v_proj"):
            assert seams[name] == {(f32, bf16)}, (name, seams[name])
    else:
        assert seams["edge_block"] == {(f32, f32)} and seams["node_block"] == {(f32, f32)}
    assert seams["decode_module"] == {(f32, bf16 if K == 0 else f32)}
    assert out.dtype == f32 and model.dtype == bf16
    assert all(p.dtype == f32 and p.grad.dtype == f32 for p in model.parameters())

    # the f32 port against the same bf16 JAX model: out of both tolerances
    _, out32, grads32 = _port_run(kind, K, "f32", params, g)
    fwd32, grad32, _ = _errors(want_out, want_grads, out32, grads32, g.node_mask)
    assert fwd32 > FWD_RTOL and grad32 > GRAD_RTOL, (fwd32, grad32)


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_bf16"))


def _jax_and_port_losses(param, kind, port_param=None):
    """10 steps of the JAX ``Trainer`` on ``param`` and of the port's on
    ``port_param`` (default the same), from the JAX weights."""
    edges = kind == "epd"
    jax_layout = {"edge_layout": "csr"} if kind == "transformer" else {}
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges),
                                use_edge_feature=edges, **jax_layout)
    port_param = port_param or param
    ds = get_dataset(port_param, get_preprocessing(port_param, use_edge_feature=edges),
                     use_edge_feature=edges)
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0)
    loader = GraphLoader(ds, batch_size=2, shuffle=True)
    interpret = pltpu.force_tpu_interpret_mode() if kind == "transformer" else contextlib.nullcontext()
    with interpret:
        jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, metrics_path=None,
                                 rollout_dir=None)
        jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
        trainer = Trainer(port_param, learning_rate=1e-3, warmup=3, device="cpu")
        trainer.init_state(10)
        state = jax_trainer.state
        load_reference_checkpoint(
            trainer.sim,
            export_reference_checkpoint({"params": state["params"], "normalizer": state["normalizer"]}),
        )
        losses, jax_losses = [], []
        for epoch in range(2):  # 5 batches of 2 frames an epoch
            jax_loader.set_epoch(epoch)
            loader.set_epoch(epoch)
            for jb, b in zip(jax_loader, loader):
                jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
                jax_losses.append(float(jloss))
                losses.append(trainer.train_step(b).item())
                assert all(p.grad.dtype == torch.float32 for p in trainer.sim.parameters())
    return np.array(losses), np.array(jax_losses), trainer


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_ten_bf16_train_steps_match_the_jax_trainer(cylinder, kind):
    param = cylinder_param(*cylinder, kind, hidden=32)
    param["model"]["precision"] = "bf16"
    losses, jax_losses, trainer = _jax_and_port_losses(param, kind)
    assert trainer.sim.model.dtype == torch.bfloat16
    # the normalizers stay f32
    assert all(b.dtype in (torch.float32, torch.int64) for b in trainer.sim.buffers())
    assert len(losses) == 10 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_RTOL)
