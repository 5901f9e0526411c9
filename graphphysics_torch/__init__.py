"""graphphysics_torch — the PyTorch / CUDA port of ``graphphysics_tpu``.

The same subpackage layout and module names as the JAX package, so each
module's counterpart is found by its path. Plain tensor code is PyTorch; the
segment sum that the JAX package wrote as a Pallas TPU kernel is a CUDA C++
kernel for Hopper (``csrc/``), built with ``nvcc`` at first use and never at
import. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; a kernel wrapper launches its kernel for a CUDA tensor and
takes its plain PyTorch version only for a CPU tensor.
"""

__version__ = "0.1.0"
