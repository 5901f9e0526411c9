"""Combined ``grph-torch`` entry point (counterpart of
``graphphysics_tpu/cli/__main__.py``): ``grph-torch train ...``,
``grph-torch predict ...``, ``grph-torch doctor ...`` and
``grph-torch export ...`` dispatch to their CLIs, and bare flags go to
train."""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "predict":
        from graphphysics_torch.cli.predict import main as predict_main

        return predict_main(argv[1:])
    if argv and argv[0] == "doctor":
        from graphphysics_torch.cli.doctor import main as doctor_main

        return doctor_main(argv[1:])
    if argv and argv[0] == "export":
        from graphphysics_torch.cli.export import main as export_main

        return export_main(argv[1:])
    if argv and argv[0] == "train":
        argv = argv[1:]
    from graphphysics_torch.cli.train import main as train_main

    return train_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
