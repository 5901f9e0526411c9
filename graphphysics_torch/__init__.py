"""graphphysics_torch — the PyTorch / CUDA port of ``graphphysics_tpu``.

The same subpackage layout and module names as the JAX package, so each
module's counterpart is found by its path. Plain tensor code is PyTorch;
each kernel that the JAX package wrote in Pallas for the TPU (the segment sum,
the attention's segment softmax + SpMM) is a CUDA C++ kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use and never at import; the
host C++ graph builders of the data path (``native/``) are built with
``g++`` the same way. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; a kernel wrapper launches its kernel for a CUDA tensor and
takes its plain PyTorch version only for a CPU tensor.
"""

__version__ = "0.1.0"
