"""Port twin of ``tests/test_compilation_cache.py``
(``graphphysics_torch/utils/compilation_cache.py``): the kernels' libraries
are built into the cache directory and reused from it. ``nvcc`` is a fake
here (this machine has none) that writes its output file."""

from graphphysics_torch.ops import _native
from graphphysics_torch.utils.compilation_cache import enable_compilation_cache
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def test_enable_compilation_cache_persists_libraries(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR)  # restored after the test
    cache_dir = tmp_path / "kernel_cache"
    assert enable_compilation_cache(str(cache_dir)) == cache_dir
    assert _native.library_path("csr_segment_sum.cu").parent == cache_dir
    first = _native.build(["csr_segment_sum.cu"])["csr_segment_sum.cu"]
    assert first > 0
    assert [p.name for p in cache_dir.iterdir()] == [_native.library_path("csr_segment_sum.cu").name]
    assert _native.build(["csr_segment_sum.cu"]) == {"csr_segment_sum.cu": 0.0}  # reused
