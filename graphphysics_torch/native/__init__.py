"""The host C++ graph builders of the data path (counterpart of
``graphphysics_tpu/native/``): ``face_to_edge_native``, ``k_hop_native``
and ``build_ell_native``, bound with ctypes to ``graph_native.cpp``.

The library is built with ``g++`` at its first use, never at import, into
the kernels' build directory (``ops._native.BUILD_DIR``: ``csrc/build`` in
the checkout, listed in ``.gitignore``, or the one
``utils.compilation_cache`` names), named by a hash of the source, so an
edited source is rebuilt and an unchanged one reused. The compiler writes
a temporary file that ``os.replace`` puts in place, so processes that
build at once never load half a file, and it runs under ``GXX_TIMEOUT_S``:
a compiler that has not finished by then is killed and the build raises
with its output, as does a compiler that fails. There is no other path:
the plain numpy versions (``topology.build.face_to_edge_reference``,
``k_hop_edges_reference``, ``topology.ell.build_ell_reference``) are what
the tests hold these functions to, not a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("graph_native.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# the source builds in seconds; minutes mean a stuck compiler
GXX_TIMEOUT_S = 120.0
_INT32_MAX = np.iinfo(np.int32).max

_lock = threading.Lock()  # the loader's prefetch thread and the caller may both load
_lib = None


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the host graph builders are built from "
                           f"{SOURCE} with it")
    return found


def library_path() -> Path:
    """The library of ``graph_native.cpp`` in the build directory, named by
    a hash of the source."""
    from graphphysics_torch.ops import _native

    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return _native.BUILD_DIR / f"libgraph_native-{digest}.so"


def build(timeout: float = GXX_TIMEOUT_S) -> float:
    """Compile the library if it is missing; returns the build's seconds
    (0.0 if it existed). Raises with the compiler's output if ``g++``
    fails or has not finished within ``timeout`` seconds (then killed)."""
    path = library_path()
    if path.exists():
        return 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    log_path = path.with_name(f"{path.name}.{os.getpid()}.log")
    cmd = [gxx_path(), *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        with open(log_path, "w+") as log:
            # a session of its own: a timeout kills g++ and the compilers it started
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                log.seek(0)
                raise RuntimeError(f"g++ did not finish within {timeout:.0f} s for {SOURCE.name}\n"
                                   f"{log.read()}") from None
            if proc.returncode != 0:
                log.seek(0)
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{log.read()}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    finally:
        log_path.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded library, compiled first if it is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gn_face_to_edge.argtypes = [i64p, i64, i64, i32p, i32p]
        lib.gn_face_to_edge.restype = i64
        lib.gn_k_hop.argtypes = [i64p, i64p, i64, i64, i64, ctypes.POINTER(i32p),
                                 ctypes.POINTER(i32p)]
        lib.gn_k_hop.restype = i64
        lib.gn_free.argtypes = [ctypes.c_void_p]
        lib.gn_free.restype = None
        lib.gn_build_ell.argtypes = [i64p, i64p, i64, i64, i64, i32p,
                                     ctypes.POINTER(ctypes.c_uint8), i32p, i32p, i64p]
        lib.gn_build_ell.restype = i64
        _lib = lib
        return lib


def _ids(a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind not in "iu":
        raise TypeError(f"{name}: node ids must be integers, got {a.dtype}")
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray, ctype=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _nodes(num_nodes: int) -> int:
    num_nodes = int(num_nodes)
    if not 0 <= num_nodes <= _INT32_MAX:
        raise ValueError(f"num_nodes {num_nodes} outside [0, {_INT32_MAX}]: the edges are int32")
    return num_nodes


def _checked(rc: int, what: str, num_nodes: int) -> int:
    if rc == -3:
        raise ValueError(f"{what}: a node id lies outside [0, {num_nodes})")
    if rc == -4:
        raise MemoryError(f"{what}: the host C++ could not allocate its result")
    return rc


def face_to_edge_native(faces: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Triangles ``[F, 3]`` (ids below ``num_nodes``) -> their sides in
    both directions, without self loops, deduplicated and sorted by
    (sender, receiver), as int32."""
    faces = _ids(faces, "faces")
    if faces.ndim != 2 or faces.shape[-1] != 3:
        raise ValueError(f"expected [F, 3] triangles, got {faces.shape}")
    num_nodes = _nodes(num_nodes)
    lib = load()
    out_s = np.empty(6 * len(faces), np.int32)
    out_r = np.empty(6 * len(faces), np.int32)
    n = _checked(lib.gn_face_to_edge(_ptr(faces), len(faces), num_nodes,
                                     _ptr(out_s, ctypes.c_int32), _ptr(out_r, ctypes.c_int32)),
                 "face_to_edge", num_nodes)
    return out_s[:n].copy(), out_r[:n].copy()


def k_hop_native(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Every pair joined by a walk of at most ``k`` edges, without self
    loops, sorted by (sender, receiver), as int32."""
    s, r = _ids(senders, "senders"), _ids(receivers, "receivers")
    if s.shape != r.shape or s.ndim != 1:
        raise ValueError(f"senders {s.shape} and receivers {r.shape} must be one [E] shape")
    num_nodes = _nodes(num_nodes)
    lib = load()
    out_s, out_r = ctypes.POINTER(ctypes.c_int32)(), ctypes.POINTER(ctypes.c_int32)()
    n = _checked(lib.gn_k_hop(_ptr(s), _ptr(r), len(s), num_nodes, int(k), ctypes.byref(out_s),
                              ctypes.byref(out_r)), "k_hop", num_nodes)
    try:
        if n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return (np.ctypeslib.as_array(out_s, (n,)).copy(),
                np.ctypeslib.as_array(out_r, (n,)).copy())
    finally:
        lib.gn_free(out_s)
        lib.gn_free(out_r)


def build_ell_native(senders: np.ndarray, receivers: np.ndarray, num_nodes: int, degree: int):
    """``(senders_ell, mask, edge_perm, twin_perm)``, each ``[num_nodes *
    degree]`` (int32, bool, int32, int32): the ELL slots of a symmetric edge
    list, grouped by receiver in input order. Raises ``ValueError`` as the
    numpy path does when a node's in-degree exceeds ``degree`` or an edge
    has no reversed twin."""
    s, r = _ids(senders, "senders"), _ids(receivers, "receivers")
    if s.shape != r.shape or s.ndim != 1:
        raise ValueError(f"senders {s.shape} and receivers {r.shape} must be one [E] shape")
    num_nodes, degree = _nodes(num_nodes), int(degree)
    slots = num_nodes * degree
    if degree < 0 or slots > _INT32_MAX:
        raise ValueError(f"{num_nodes} nodes x degree {degree} slots do not fit int32")
    lib = load()
    senders_ell = np.empty(slots, np.int32)
    mask = np.empty(slots, np.uint8)
    edge_perm = np.empty(slots, np.int32)
    twin_perm = np.empty(slots, np.int32)
    detail = ctypes.c_int64(0)
    rc = _checked(lib.gn_build_ell(
        _ptr(s), _ptr(r), len(s), num_nodes, degree, _ptr(senders_ell, ctypes.c_int32),
        _ptr(mask, ctypes.c_uint8), _ptr(edge_perm, ctypes.c_int32),
        _ptr(twin_perm, ctypes.c_int32), ctypes.byref(detail)), "build_ell", num_nodes)
    if rc == -1:
        raise ValueError(f"max in-degree {detail.value} exceeds ELL degree {degree}")
    if rc == -2:
        raise ValueError(f"edge list is not symmetric: {detail.value} edges have no reverse twin")
    return senders_ell, mask.view(bool), edge_perm, twin_perm
