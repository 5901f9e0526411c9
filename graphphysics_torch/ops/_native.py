"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Nothing is built when a module is imported: ``load(source)`` builds the
library at its first call. Libraries are named by a hash of their source, so
an edited source is rebuilt and an unchanged one is reused; the build
directory is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


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
    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if it is missing;
    raises with the compiler's output if ``nvcc`` fails."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    path = library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{out.stdout}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    lib = _loaded[source] = ctypes.CDLL(str(path))
    return lib
