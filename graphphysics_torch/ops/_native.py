"""Build, load and register the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Nothing is built when a module is imported: ``load(source)`` builds the
library at its first call, and ``build()`` builds every source at once, one
``nvcc`` process per source, all started together. Every build is bounded by
``NVCC_TIMEOUT_S``: a compiler that has not finished by then is killed and
the build raises with its output. Libraries are named by a hash of their
source, so an edited source is rebuilt and an unchanged one is reused; the
build directory (``csrc/build`` in the checkout, listed in ``.gitignore``,
or the one ``set_build_dir`` names: ``utils.compilation_cache``) keeps
them across processes. A source may include the ``csrc/*.cuh`` headers;
they are part of every library's hash.

``register_op`` makes a kernel entry a ``torch.library`` operator of the
``graphphysics_torch`` namespace (``OPS``): its CUDA implementation
launches the kernel, its CPU implementation is the plain version, its fake
implementation gives shapes and dtypes (what ``torch.export`` traces). The
functions are registered as they are, each called by the dispatcher for
its device; the callers' ``torch.autograd.Function``s call the forward and
backward operators.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
OPS = "graphphysics_torch"  # the torch.library namespace of the kernels' operators
SOURCES = (
    "csr_segment_sum.cu", "csr_softmax_spmm.cu", "csr_softmax_spmm_bwd.cu",
    "csr_attention.cu", "csr_attention_bwd.cu", "csr_attention_bf16.cu",
    "csr_attention_bwd_bf16.cu", "csr_attention_bf16_words.cu", "csr_softmax_spmm_pair.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# a plain-C source builds in seconds; minutes mean a stuck compiler
NVCC_TIMEOUT_S = 300.0

BUILD_DIR = CSRC / "build"  # where the libraries are built and looked for (set_build_dir)

_loaded: Dict[str, ctypes.CDLL] = {}


def set_build_dir(path) -> Path:
    """Build and look for the libraries under ``path`` from now on (made if
    missing); a library already loaded stays loaded. Returns the directory."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(candidate):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
            "CUDA kernels are built from csrc/ on a machine with the toolkit"
        )
    return candidate


def library_path(source: str) -> Path:
    """The library of ``source``, named by a hash of the source and of every
    header in ``csrc/`` (which it may include)."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(
    sources: Sequence[str] = SOURCES, timeout: float = NVCC_TIMEOUT_S
) -> Dict[str, float]:
    """Compile every missing library of ``sources``, one ``nvcc`` each, all
    running at once. Returns each source's build seconds (0.0 where the
    library already existed). Raises with the compiler's output if one fails
    or if they have not all finished within ``timeout`` seconds, after
    killing the ones still running."""
    seconds = {s: 0.0 for s in sources}
    running = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        for source in sources:
            path = library_path(source)
            if path.exists():
                continue
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            log = open(path.with_name(f"{path.name}.{os.getpid()}.log"), "w+")
            try:
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            except OSError:
                log.close()
                Path(log.name).unlink(missing_ok=True)
                raise
            running[source] = (proc, log, tmp, path)
        pending = dict(running)
        while pending:
            for source, (proc, log, tmp, path) in list(pending.items()):
                if proc.poll() is None:
                    continue
                del pending[source]
                seconds[source] = time.perf_counter() - t0
                if proc.returncode != 0:
                    log.seek(0)
                    raise RuntimeError(f"nvcc failed for {source}:\n{log.read()}")
                os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
            if pending and time.perf_counter() - t0 > timeout:
                names = ", ".join(pending)
                outputs = []
                for source, (proc, log, _, _) in pending.items():
                    proc.kill()
                    proc.wait()
                    log.seek(0)
                    outputs.append(f"--- {source}:\n{log.read()}")
                raise RuntimeError(
                    f"nvcc did not finish within {timeout:.0f} s for {names}\n"
                    + "\n".join(outputs)
                )
            time.sleep(0.05)
    finally:
        for proc, log, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            Path(log.name).unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if it is missing;
    raises with the compiler's output if ``nvcc`` fails or times out."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    path = library_path(source)
    if not path.exists():
        build([source])
    lib = _loaded[source] = ctypes.CDLL(str(path))
    return lib


def function(source: str, name: str, pointers: int, ints: Sequence) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``source``'s library (built first if it is
    missing), typed as ``pointers`` device pointers, then the ctypes integer
    types ``ints``, then the stream, returning the CUDA error code."""
    fn = getattr(load(source), name)
    fn.argtypes = [ctypes.c_void_p] * pointers + list(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def register_op(name: str, schema: str, cpu: Callable, cuda: Callable,
                fake: Callable) -> torch._ops.OpOverload:
    """Define the operator ``graphphysics_torch::name`` with ``schema`` and
    its CPU, CUDA and fake implementations; returns the operator. No other
    device has an implementation."""
    qualname = f"{OPS}::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cpu", cpu)
    torch.library.impl(qualname, "cuda", cuda)
    torch.library.register_fake(qualname, fake)
    return getattr(getattr(torch.ops, OPS), name).default
