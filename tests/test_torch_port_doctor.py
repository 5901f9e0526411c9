"""Port twins of ``tests/test_doctor.py``: ``grph-torch doctor`` runs clean
on the CPU, and the probes measure something."""

import torch

from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def test_doctor_passes(capsys):
    from graphphysics_torch.cli.doctor import main

    rc = main(["--device", "cpu", "--skip-probes"])  # the probes have their own test below
    out = capsys.readouterr().out
    assert rc == 0
    assert "all checks passed (6/6)" in out
    for kind in ("epd f32", "transformer f32", "transformer bf16"):
        assert f"ok    train-step determinism, {kind} - replays bit for bit" in out


def test_chip_probes_return_positive():
    from graphphysics_torch.utils.profiling import chip_probe_gbps, chip_probe_tflops

    for dtype in (torch.float32, torch.bfloat16):
        assert chip_probe_tflops(n=256, depth=2, reps=1, dtype=dtype, device="cpu") > 0
    assert chip_probe_gbps(mb=8, depth=2, reps=1, device="cpu") > 0
