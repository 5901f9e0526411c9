"""Combined ``grph-torch`` entry point (counterpart of
``graphphysics_tpu/cli/__main__.py``): ``grph-torch train ...`` and
``grph-torch predict ...`` dispatch to the two CLIs, and bare flags go to
train. ``doctor`` and ``export`` are not ported yet."""

from __future__ import annotations

import sys

NOT_PORTED = {"doctor": 12, "export": 12}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        raise SystemExit(
            f"grph-torch {argv[0]} is not ported yet (ROADMAP.md section 1, item {NOT_PORTED[argv[0]]})"
        )
    if argv and argv[0] == "predict":
        from graphphysics_torch.cli.predict import main as predict_main

        return predict_main(argv[1:])
    if argv and argv[0] == "train":
        argv = argv[1:]
    from graphphysics_torch.cli.train import main as train_main

    return train_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
