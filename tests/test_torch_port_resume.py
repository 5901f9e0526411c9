"""Port twins of the JAX trainer's resume tests: a SIGTERM mid-epoch saves a
checkpoint at the next step boundary, and ``fit(resume_from=)`` continues
the loader's deterministic stream so that the resumed run ends bitwise
where the uninterrupted one does (parameters, normalizers, optimizer state,
step, metric rows); mid-epoch saves with ``save_every_n_steps``; the
schedule rebuilt on resume. Both model families, on the CPU."""

import csv
import os
import signal

import pytest
import torch

from graphphysics_torch.training import load_checkpoint, load_metadata
from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_resume"))


class _SignalAfter:
    """A loader that sends this process SIGTERM while its batch ``after``
    is in flight."""

    def __init__(self, loader, after):
        self.loader, self.after = loader, after

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_start_batch(self, batch):
        self.loader.set_start_batch(batch)

    def __iter__(self):
        for i, item in enumerate(self.loader):
            if i == self.after - 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield item


def _rows(path):
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]


def _state(trainer):
    opt = trainer.optimizer.state_dict()
    return trainer.sim.state_dict(), [opt["state"][i] for i in sorted(opt["state"])]


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_preemption_mid_epoch_resume_exact(cylinder, tmp_path, kind):
    param = cylinder_param(*cylinder, kind)
    trainer_a, loader_a, val_a = port_trainer(param, tmp_path / "a")
    history_a = trainer_a.fit(loader_a, val_dataset=val_a, num_epochs=2, val_trajectories=1)

    trainer_b, loader_b, val_b = port_trainer(param, tmp_path / "b")
    handler = signal.getsignal(signal.SIGTERM)
    history_b = trainer_b.fit(_SignalAfter(loader_b, after=2), val_dataset=val_b, num_epochs=2,
                              val_trajectories=1)
    assert history_b["interrupted"] and trainer_b.step == 2
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    ckpt = str(tmp_path / "b" / "ckpt" / "state.pt")
    meta = load_metadata(ckpt)
    assert meta["epoch"] == 0 and meta["batch_offset"] == 2 and meta["step"] == 2

    trainer_c, loader_c, val_c = port_trainer(param, tmp_path / "b")
    history_c = trainer_c.fit(loader_c, val_dataset=val_c, num_epochs=2, resume_from=ckpt,
                              val_trajectories=1)
    assert not history_c["interrupted"]
    assert trainer_c.step == trainer_a.step == 2 * len(loader_a)
    assert trainer_c.scheduler.last_epoch == trainer_a.scheduler.last_epoch
    assert trainer_c.optimizer.param_groups[0]["lr"] == trainer_a.optimizer.param_groups[0]["lr"]
    (sd_a, opt_a), (sd_c, opt_c) = _state(trainer_a), _state(trainer_c)
    assert sd_a.keys() == sd_c.keys()
    for key in sd_a:
        assert torch.equal(sd_a[key], sd_c[key]), key
    for sa, sc in zip(opt_a, opt_c):
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[name], sc[name]), name
    # the resumed epoch reports the mean over all its batches
    assert history_c["train_loss"] == history_a["train_loss"]
    assert history_c["val_rmse"] == history_a["val_rmse"]
    assert _rows(tmp_path / "b" / "metrics.csv") == _rows(tmp_path / "a" / "metrics.csv")


def test_save_every_n_steps_writes_mid_epoch_metadata(cylinder, tmp_path):
    trainer, loader, _ = port_trainer(cylinder_param(*cylinder, "epd"), tmp_path / "p",
                                      save_every_n_steps=1)
    seen = []
    orig = trainer.save

    def spy(epoch, batch_offset=None, epoch_loss=None):
        orig(epoch, batch_offset=batch_offset, epoch_loss=epoch_loss)
        seen.append((epoch, batch_offset))

    trainer.save = spy
    trainer.fit(loader, num_epochs=1)
    # every step saved with its batch offset, then the end-of-epoch save
    assert seen[:-1] == [(0, k + 1) for k in range(len(loader))]
    assert seen[-1] == (0, None)
    assert load_metadata(str(tmp_path / "p" / "ckpt" / "state.pt"))["epoch"] == 1


def test_request_interrupt_and_resume_from_an_epoch_end(cylinder, tmp_path):
    """``request_interrupt`` stops at the step boundary like a signal; a
    resume from an end-of-epoch checkpoint under a longer run rebuilds the
    schedule for the new step count at the restored position."""
    param = cylinder_param(*cylinder, "epd")
    trainer, loader, _ = port_trainer(param, tmp_path / "r")

    class Stop:
        def __len__(self):
            return len(loader)

        def set_epoch(self, epoch):
            loader.set_epoch(epoch)

        def __iter__(self):
            for i, batch in enumerate(loader):
                if i == 1:
                    trainer.request_interrupt()
                yield batch

    assert trainer.fit(Stop(), num_epochs=1)["interrupted"]
    assert load_metadata(str(tmp_path / "r" / "ckpt" / "state.pt"))["batch_offset"] == 2
    trainer.fit(loader, num_epochs=1, resume_from=str(tmp_path / "r" / "ckpt" / "state.pt"))
    ckpt = str(tmp_path / "r" / "ckpt" / "state.pt")
    assert load_metadata(ckpt) == {"epoch": 1, "step": len(loader), "wandb_run_id": None}

    n = len(loader)
    # the schedule is the new run's, at the restored position
    fresh, _, _ = port_trainer(param, tmp_path / "r")
    fresh.init_state(3 * n)
    load_checkpoint(ckpt, fresh)
    assert fresh.step == fresh.scheduler.last_epoch == n
    assert fresh.optimizer.param_groups[0]["lr"] == fresh.schedule(n) != trainer.schedule(n)

    resumed, loader3, _ = port_trainer(param, tmp_path / "r")
    history = resumed.fit(loader3, num_epochs=3, resume_from=ckpt)
    assert resumed.step == 3 * n and len(history["train_loss"]) == 2
    assert resumed.scheduler.last_epoch == 3 * n
    assert resumed.optimizer.param_groups[0]["lr"] == resumed.schedule(3 * n)
