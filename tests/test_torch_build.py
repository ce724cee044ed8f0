"""When ``ops/cuda.build`` rebuilds a kernel library.

A library is stale when one of its ``.cu`` sources, or any ``csrc/*.cuh``
header (the flash-attention sources share ``tensor_core.cuh``), is newer
than it. Here, without ``nvcc``, a rebuild shows as the build raising
``MXNetError`` naming nvcc; a library that is up to date comes back as it
is, with no compiler asked for.
"""
import os
import shutil

import pytest

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda as cuda_ops
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture()
def tree(monkeypatch, tmp_path):
    """A csrc/ with one source and one header, a build/ with its library,
    and no nvcc to be found."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    for name in ("kern.cu", "shared.cuh"):
        (csrc / name).write_text("// source\n")
    (build / "libkern.so").write_bytes(b"not a real library")
    monkeypatch.setattr(cuda_ops, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", build)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def stamp(**mtimes):
        for rel, t in mtimes.items():
            path = {"cu": csrc / "kern.cu", "cuh": csrc / "shared.cuh",
                    "so": build / "libkern.so"}[rel]
            os.utime(path, (t, t))
    return build / "libkern.so", stamp


def test_library_newer_than_source_and_header_is_kept(tree):
    so, stamp = tree
    stamp(cu=1_000, cuh=2_000, so=3_000)
    assert cuda_ops.build("kern", ["kern.cu"]) == so


def test_header_newer_than_library_rebuilds(tree):
    so, stamp = tree
    stamp(cu=1_000, so=2_000, cuh=3_000)   # the library is newer than its .cu
    with pytest.raises(MXNetError, match="nvcc"):
        cuda_ops.build("kern", ["kern.cu"])


def test_source_newer_than_library_rebuilds(tree):
    so, stamp = tree
    stamp(cuh=1_000, so=2_000, cu=3_000)
    with pytest.raises(MXNetError, match="nvcc"):
        cuda_ops.build("kern", ["kern.cu"])


def test_missing_library_builds(tree):
    so, stamp = tree
    so.unlink()
    with pytest.raises(MXNetError, match="nvcc"):
        cuda_ops.build("kern", ["kern.cu"])
