"""Port twins of the JAX CLI and fit-artifact tests, run in-process on the
CPU (``--device cpu``): ``fit`` writes its checkpoint, CSV metrics and XDMF
rollouts; the train CLI, the combined ``grph-torch`` dispatcher, and the
train -> predict -> retrain flow of ``train.sh``, ``predict.sh`` and
``retrain.sh``, whose ``metrics.csv`` header is the JAX CLI's on the same
config; the XDMF configurations (coarse-aneurysm and c-a-gmm with the
aneurysm hook and previous data, panels) through train and predict; every
flag of a feature not ported yet exits naming its ROADMAP item."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from graphphysics_torch.cli import export as export_cli
from graphphysics_torch.cli import predict as predict_cli
from graphphysics_torch.cli import train as train_cli
from graphphysics_torch.cli.__main__ import main as grph_torch
from graphphysics_torch.training import get_dataset, get_preprocessing, load_metadata
from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split

TRAIN_FLAGS = ["--batch_size", "2", "--warmup", "5", "--val_trajectories", "1"]


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_cli"))


@pytest.fixture
def config(cylinder, tmp_path, monkeypatch):
    """The EPD fixture config as a JSON file, the working directory a fresh
    temporary one (the CLIs write there by default)."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cylinder_param(*cylinder, "epd")))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return str(path), work


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_fit_decreases_loss_and_validates(cylinder, tmp_path, kind):
    trainer, loader, val_ds = port_trainer(cylinder_param(*cylinder, kind), tmp_path, log_every=5)
    history = trainer.fit(loader, val_dataset=val_ds, num_epochs=3)
    assert len(history["train_loss"]) == 3 and not history["interrupted"]
    assert history["train_loss"][-1] < history["train_loss"][0]
    assert all(np.isfinite(v) for v in history["val_rmse"])
    # artifacts
    assert load_metadata(str(tmp_path / "ckpt" / "state.pt"))["epoch"] == 3
    assert _header(tmp_path / "metrics.csv") == [
        "time", "epoch", "step", "train_loss", "lr", "train_loss_epoch", "val_all_rollout_rmse",
        "val_loss"]
    for epoch in range(3):
        files = os.listdir(tmp_path / "meshes" / f"epoch_{epoch}")
        assert f"graph_epoch_{epoch}_0.xdmf" in files


def test_cli_train_smoke(config):
    cfg, work = config
    rc = train_cli.main(["--training_parameters_path", cfg, "--num_epochs", "1", *TRAIN_FLAGS,
                         "--device", "cpu"])
    assert rc == 0
    assert os.path.exists(work / "checkpoints" / "state.pt")
    assert os.path.exists(work / "metrics.csv")


def test_grph_combined_cli_dispatch(config):
    """``grph-torch train ...`` (and bare flags) reach the train CLI,
    ``grph-torch predict`` the predict CLI, ``grph-torch export`` and
    ``grph-torch doctor`` theirs."""
    cfg, work = config
    assert grph_torch(["train", "--training_parameters_path", cfg, "--num_epochs", "1",
                       *TRAIN_FLAGS, "--device", "cpu"]) == 0
    ckpt = str(work / "checkpoints" / "state.pt")
    assert load_metadata(ckpt)["epoch"] == 1
    assert grph_torch(["--training_parameters_path", cfg, "--num_epochs", "1", *TRAIN_FLAGS,
                       "--checkpoint_dir", "bare", "--device", "cpu"]) == 0
    assert os.path.exists(work / "bare" / "state.pt")
    assert grph_torch(["predict", "--training_parameters_path", cfg, "--model_path", ckpt,
                       "--save_dir", str(work / "preds"), "--max_trajectories", "1",
                       "--device", "cpu"]) == 0
    assert sorted(os.listdir(work / "preds")) == ["graph_0.h5", "graph_0.xdmf"]
    assert grph_torch(["export", "--training_parameters_path", cfg, "--model_path", ckpt,
                       "--output_dir", str(work / "exported"), "--device", "cpu"]) == 0
    assert os.listdir(work / "exported") == ["eval_step.pt2"]
    assert grph_torch(["doctor", "--device", "cpu", "--skip-probes", "--skip-determinism"]) == 0


def test_train_predict_retrain_flow_and_jax_metrics_header(config, tmp_path, monkeypatch):
    """The shell scripts' flow: train 1 epoch saving ``mock.pt``, predict
    every test trajectory from it, resume to 2 epochs; then the JAX CLI on
    the same config writes the same ``metrics.csv`` header."""
    cfg, work = config
    flags = ["--training_parameters_path", cfg, *TRAIN_FLAGS[:4], "--model_save_name", "mock.pt",
             "--device", "cpu"]
    assert train_cli.main([*flags, "--num_epochs", "1"]) == 0
    ckpt = str(work / "checkpoints" / "mock.pt")
    steps = load_metadata(ckpt)["step"]
    assert predict_cli.main(["--training_parameters_path", cfg, "--model_path", ckpt,
                             "--save_dir", "predictions", "--device", "cpu"]) == 0
    params = json.loads(open(cfg).read())
    test_ds = get_dataset(params, get_preprocessing(params, remove_noise=True), switch_to_val=True)
    xdmf = sorted(f for f in os.listdir(work / "predictions") if f.endswith(".xdmf"))
    assert xdmf == [f"graph_{t}.xdmf" for t in range(test_ds.size_dataset)]
    before = torch.load(ckpt, weights_only=True)["model"]
    assert train_cli.main([*flags, "--num_epochs", "2", "--resume_training",
                           "--model_path", ckpt]) == 0
    meta = load_metadata(ckpt)
    assert meta["epoch"] == 2 and meta["step"] == 2 * steps
    after = torch.load(ckpt, weights_only=True)["model"]
    assert any(not torch.equal(before[k], after[k]) for k in before)
    rows = list(csv.DictReader(open(work / "metrics.csv")))
    assert [r["epoch"] for r in rows] == ["0", "1"]  # one row per validated epoch

    from graphphysics_tpu.cli.train import main as jax_train

    jax_work = tmp_path / "jax_work"
    jax_work.mkdir()
    monkeypatch.chdir(jax_work)
    assert jax_train(["--training_parameters_path", cfg, *TRAIN_FLAGS, "--num_epochs", "1"]) == 0
    assert _header(jax_work / "metrics.csv") == _header(work / "metrics.csv")


def test_gmm_config_through_train_predict_resume(cylinder, tmp_path, monkeypatch):
    """A GMM config (the fixture's EPD with ``"num_mixture_components": 2``)
    passes through both CLIs with no flag of its own: train 1 epoch, predict
    twice from the checkpoint (the sampled frames repeat exactly: the draws
    come from ``(seed, trajectory)``), resume to 2 epochs."""
    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader

    param = cylinder_param(*cylinder, "epd")
    param["model"]["num_mixture_components"] = 2
    cfg = tmp_path / "gmm.json"
    cfg.write_text(json.dumps(param))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    flags = ["--training_parameters_path", str(cfg), *TRAIN_FLAGS, "--model_save_name", "gmm.pt",
             "--device", "cpu"]
    assert train_cli.main([*flags, "--num_epochs", "1"]) == 0
    ckpt = str(work / "checkpoints" / "gmm.pt")
    assert torch.load(ckpt, weights_only=True)["model"]["model.decode_module.proj.weight"].shape[0] == 10
    frames = []
    for out in ("p1", "p2"):
        assert predict_cli.main(["--training_parameters_path", str(cfg), "--model_path", ckpt,
                                 "--save_dir", out, "--max_trajectories", "1", "--device", "cpu"]) == 0
        with XdmfTimeSeriesReader(str(work / out / "graph_0.xdmf")) as reader:
            frames.append([reader.read_data(k)[1]["prediction"] for k in range(reader.num_steps)])
    assert len(frames[0]) > 0 and all(np.isfinite(f).all() for f in frames[0])
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)
    steps = load_metadata(ckpt)["step"]
    assert train_cli.main([*flags, "--num_epochs", "2", "--resume_training", "--model_path", ckpt]) == 0
    meta = load_metadata(ckpt)
    assert meta["epoch"] == 2 and meta["step"] == 2 * steps
    rows = list(csv.DictReader(open(work / "metrics.csv")))
    assert [r["epoch"] for r in rows] == ["0", "1"] and not any(r.get("val_loss") for r in rows)


@pytest.mark.parametrize("cli,flag,item", [
    *[(train_cli, f, i) for f, _, i in train_cli.NOT_PORTED],
    *[(export_cli, f, i) for f, _, i in export_cli.NOT_PORTED],
])
def test_flags_not_ported_exit_naming_their_item(cli, flag, item, config, capsys):
    cfg, _ = config
    value = {
        "prefetch_factor": "4", "num_workers": "2", "masking_ratio": "0.5", "graph_partition": "2",
        "partition_mode": "gather", "partition_edge_headroom": "1.0", "partition_reorder": "rcm",
        "halo_dtype": "bf16", "checkpoint_backend": "orbax", "profile_dir": "trace",
        "compilation_cache_dir": "cache", "external_features": "bezier",
    }.get(flag)
    argv = ["--training_parameters_path", cfg, f"--{flag}", *([value] if value else [])]
    if cli is export_cli:
        argv += ["--model_path", "none.pt"]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert f"--{flag} is not ported yet (ROADMAP.md section 1, item {item})" in capsys.readouterr().err


def test_get_dataset_refuses_what_is_not_ported(cylinder):
    param = cylinder_param(*cylinder, "epd")
    pre = get_preprocessing(param)
    # size buckets are ported: the fixture's one mesh size collapses them
    ds = get_dataset(param, pre, num_buckets=2)
    assert ds[0].x.shape[0] == ds.node_budget and ds.num_buckets == 1
    # node masking is ported: each item marks int((1 - ratio) * N) nodes
    g = get_dataset(param, pre, masking_ratio=0.5)[0]
    assert int(g.exclude_mask.sum()) == int(0.5 * int(g.node_mask.sum()))
    # previous-frame data is ported: every item carries the frame before it
    ds = get_dataset(param, pre, use_previous_data=True)
    assert ds.use_previous_data and len(ds) == 2 * 4 and ds.get_traj_frame(0) == (0, 1)
    assert ds._load(0).previous_data.shape == (48, 4)  # frame 0's x: velocity, node type, time
    with pytest.raises(ValueError, match="does not fit"):
        get_dataset(param, pre, edge_layout="csr")
    assert get_dataset(param, pre, edge_layout="coo").edge_layout == "sorted"


def test_clis_run_on_cuda_unless_asked(config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg, work = config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--training_parameters_path", cfg, "--num_epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_cli.main(["--training_parameters_path", cfg, "--model_path", "none.pt"])
    assert os.listdir(work) == []


XDMF_CONFIGS = {
    "coarse-aneurysm": ["--external_features", "aneurysm", "--use_previous_data",
                        "--previous_data_start", "5", "--previous_data_end", "8"],
    "c-a-gmm": ["--external_features", "aneurysm", "--use_previous_data",
                "--previous_data_start", "5", "--previous_data_end", "8"],
    "panels": [],
}


@pytest.mark.parametrize("name", sorted(XDMF_CONFIGS))
def test_xdmf_configs_train_then_predict(name, tmp_path, monkeypatch):
    """``training_config/{name}.json`` (cut to 2 blocks of width 16) on a
    tiny XDMF folder of its schema: ``train`` with its flags (the aneurysm
    hook and previous data for the aneurysm configs), then ``predict`` from
    the checkpoint with the same flags: one file per held-out mesh, on the
    tetrahedra for the aneurysm, the first frame at ``2 * dt`` with previous
    data."""
    from graphphysics_torch.utils import synthetic
    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader

    aneurysm = name != "panels"
    write = synthetic.write_aneurysm_xdmf if aneurysm else synthetic.write_panels_xdmf
    size = {"n": 3} if aneurysm else {"nx": 6, "ny": 5}
    folder, meta_path = write(str(tmp_path / "data" / "train"), num_traj=2, steps=5, **size)
    write(str(tmp_path / "data" / "test"), num_traj=1, steps=5, seed=1, **size)
    param = json.loads(open(f"training_config/{name}.json").read())
    param["dataset"].update(xdmf_folder=folder, meta_path=meta_path)
    param["model"].update(message_passing_num=2, hidden_size=16)
    cfg = tmp_path / f"{name}.json"
    cfg.write_text(json.dumps(param))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    flags = ["--training_parameters_path", str(cfg), "--device", "cpu", *XDMF_CONFIGS[name]]
    assert train_cli.main([*flags, "--num_epochs", "1", "--batch_size", "2", "--warmup", "2"]) == 0
    ckpt = str(work / "checkpoints" / "state.pt")
    previous = bool(XDMF_CONFIGS[name])
    assert load_metadata(ckpt)["step"] == 2 * (5 - 1 - int(previous)) // 2
    assert predict_cli.main([*flags, "--model_path", ckpt, "--save_dir", "predictions"]) == 0
    # named by the mesh id, the file name's part after its last "_"
    assert sorted(os.listdir(work / "predictions")) == ["graph_0.h5", "graph_0.xdmf"]
    with XdmfTimeSeriesReader(str(work / "predictions" / "graph_0.xdmf")) as r:
        (cell_type, cells), = r.read_points_cells()[1]
        assert cell_type == ("tetra" if aneurysm else "triangle")
        assert r.num_steps == 5 - 1 - int(previous)
        times = [r.read_data(k)[0] for k in range(r.num_steps)]
        frames = [r.read_data(k)[1]["prediction"] for k in range(r.num_steps)]
        nodes = r.num_points()
    dt = json.loads(open(meta_path).read())["dt"]
    assert times[0] == pytest.approx((2 if previous else 1) * dt)
    assert all(f.shape == (nodes, 3) and np.isfinite(f).all() for f in frames)


def test_bf16_remat_panels_config_train_predict_resume(tmp_path, monkeypatch):
    """``training_config/panels.json`` with ``"precision": "bf16"`` and
    ``"remat": true`` (cut to 2 blocks of width 16) on a tiny panels XDMF
    folder: ``grph-torch train`` one epoch, ``predict`` from the checkpoint,
    ``train --resume_training`` to 2 epochs. The checkpoint holds f32
    weights: it loads into the f32 model of the same config, and back."""
    from graphphysics_torch.training import Trainer, load_checkpoint_with_metadata
    from graphphysics_torch.utils import synthetic
    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader

    folder, meta_path = synthetic.write_panels_xdmf(str(tmp_path / "data" / "train"), num_traj=2,
                                                    steps=5, nx=6, ny=5)
    synthetic.write_panels_xdmf(str(tmp_path / "data" / "test"), num_traj=1, steps=5, seed=1, nx=6, ny=5)
    param = json.loads(open("training_config/panels.json").read())
    param["dataset"].update(xdmf_folder=folder, meta_path=meta_path)
    param["model"].update(message_passing_num=2, hidden_size=16, precision="bf16", remat=True)
    cfg = tmp_path / "panels_bf16.json"
    cfg.write_text(json.dumps(param))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    flags = ["--training_parameters_path", str(cfg), "--device", "cpu", "--batch_size", "2",
             "--warmup", "2"]
    assert grph_torch(["train", *flags, "--num_epochs", "1"]) == 0
    ckpt = str(work / "checkpoints" / "state.pt")
    saved = torch.load(ckpt, weights_only=True)["model"]
    assert all(v.dtype == torch.float32 for k, v in saved.items() if "_normalizer." not in k)
    steps = load_metadata(ckpt)["step"]
    assert grph_torch(["predict", "--training_parameters_path", str(cfg), "--device", "cpu",
                       "--model_path", ckpt, "--save_dir", "predictions"]) == 0
    with XdmfTimeSeriesReader(str(work / "predictions" / "graph_0.xdmf")) as r:
        frames = [r.read_data(k)[1]["prediction"] for k in range(r.num_steps)]
    assert len(frames) == 4 and all(np.isfinite(f).all() for f in frames)
    assert grph_torch(["train", *flags, "--num_epochs", "2", "--resume_training",
                       "--model_path", ckpt]) == 0
    meta = load_metadata(ckpt)
    assert meta["epoch"] == 2 and meta["step"] == 2 * steps
    # the bf16 run's checkpoint in the f32 model, and that model's back in bf16
    f32 = json.loads(json.dumps(param))
    f32["model"].update(precision="f32", remat=False)
    trainer = Trainer(f32, metrics_path=None, rollout_dir=None, device="cpu")
    trainer.init_state(10)
    load_checkpoint_with_metadata(ckpt, trainer)
    assert trainer.sim.model.dtype is None
    sd = trainer.sim.state_dict()
    after = torch.load(ckpt, weights_only=True)["model"]
    for key, value in after.items():
        assert torch.equal(sd[key], value.reshape(sd[key].shape)), key
    trainer.checkpoint_dir = str(work / "f32")
    trainer.save(epoch=2)
    back = Trainer(param, metrics_path=None, rollout_dir=None, device="cpu")
    back.init_state(10)
    load_checkpoint_with_metadata(str(work / "f32" / trainer.checkpoint_name), back)
    assert back.sim.model.dtype == torch.bfloat16
    for key, value in back.sim.state_dict().items():
        assert torch.equal(value, sd[key]), key


@pytest.mark.parametrize("case", ["ell_epd", "ell_transformer", "buckets", "gradient_accumulation",
                                  "project_before_gather", "no_proj_bias"])
def test_training_features_through_train_predict_resume(cylinder, tmp_path, monkeypatch, case):
    """The ELL layout for both families, size buckets (on a file of two mesh
    sizes), ``--gradient_accumulation`` and the two layer knobs through the
    flow of ``train.sh``, ``predict.sh`` and ``retrain.sh``: train 1 epoch,
    predict every test trajectory, resume to 2 epochs."""
    import shutil

    from graphphysics_tpu.utils.synthetic import write_cylinder_h5

    kind = "transformer" if case in ("ell_transformer", "no_proj_bias") else "epd"
    data = cylinder
    if case == "buckets":
        data = write_cylinder_h5(str(tmp_path / "mixed"), steps=4, grids=[(6, 5), (14, 10)])
        shutil.copy(data[0], tmp_path / "mixed" / "test.h5")
    param = cylinder_param(*data, kind)
    param["dataset"].update({"ell_epd": {"edge_layout": "ell"}, "ell_transformer": {"edge_layout": "ell"},
                             "buckets": {"num_buckets": 2, "bucket_multiple": 64}}.get(case, {}))
    param["model"].update({"project_before_gather": {"project_before_gather": True},
                           "no_proj_bias": {"use_proj_bias": False}}.get(case, {}))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(param))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    flags = ["--training_parameters_path", str(cfg), *TRAIN_FLAGS, "--device", "cpu",
             *(["--gradient_accumulation"] if case == "gradient_accumulation" else [])]
    assert train_cli.main([*flags, "--num_epochs", "1"]) == 0
    ckpt = str(work / "checkpoints" / "state.pt")
    steps = load_metadata(ckpt)["step"]
    assert steps > 0
    state = torch.load(ckpt, weights_only=True)["model"]
    assert ("model.processor_list.0.attention.q_proj.bias" in state) == (
        kind == "transformer" and case != "no_proj_bias")
    assert predict_cli.main(["--training_parameters_path", str(cfg), "--model_path", ckpt,
                             "--save_dir", "predictions", "--device", "cpu"]) == 0
    test_ds = get_dataset(param, get_preprocessing(param, remove_noise=True, use_edge_feature=kind == "epd"),
                          use_edge_feature=kind == "epd", switch_to_val=True)
    assert test_ds.edge_layout == ("ell" if case.startswith("ell") else
                                   {"epd": "sorted", "transformer": "csr"}[kind])
    assert test_ds.num_buckets == (2 if case == "buckets" else 1)
    xdmf = sorted(f for f in os.listdir(work / "predictions") if f.endswith(".xdmf"))
    assert xdmf == [f"graph_{t}.xdmf" for t in range(test_ds.size_dataset)]
    assert train_cli.main([*flags, "--num_epochs", "2", "--resume_training", "--model_path", ckpt]) == 0
    meta = load_metadata(ckpt)
    assert meta["epoch"] == 2 and meta["step"] == 2 * steps
