#!/usr/bin/env python3
"""Time the fused attention kernels of one checkout of this repository, to
compare two commits on one card in one call:

    python3 chip_compare.py <checkout root> [label]

Runs ``chip_smoke.fused_case`` of that checkout (its own kernels, built from
its own ``graphphysics_torch/csrc``) on the panels batch at widths 128 and 64
with 4 heads in the model's layout, and prints one line ``COMPARE {json}``
with each kernel's device ms. Run it in turns on the two checkouts
(parent, change, change, parent). Needs one CUDA card.
"""
import json
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from graphphysics_torch.ops import _native

    if not _native.CSRC.is_relative_to(root):
        raise SystemExit(f"kernels would come from {_native.CSRC}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _native.build(("csr_attention.cu", "csr_attention_bwd.cu", "csr_softmax_spmm.cu",
                   "csr_softmax_spmm_bwd.cu"))
    batch = cs.panels_batch(200)
    out = {"tree": sys.argv[2] if len(sys.argv) > 2 else root}
    for d in (128, 64):
        f, b = cs.fused_case(f"d{d}", batch, d, 13, library=False)
        out[f"fwd_ms_{d}"] = f["ms"]
        out[f"bwd_ms_{d}"] = b["ms"]
    print("COMPARE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
