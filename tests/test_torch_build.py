"""The build's cache key (``srgan_tpu_torch/ops/cuda/build.py``): a
library's file name carries a hash of its source, the headers beside it
and the flags, so an edit to a header rebuilds every source."""

from srgan_tpu_torch.ops.cuda import build


def test_library_path_follows_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "prims.cuh"\n')
    header = tmp_path / "prims.cuh"
    header.write_text("// v1\n")
    first = build.library_path("kern")
    assert build.library_path("kern") == first
    header.write_text("// v2\n")
    second = build.library_path("kern")
    assert second != first
    assert second.parent == build.BUILD_DIR and second.name.startswith("libkern-")
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build.library_path("kern") not in (first, second)
    header.write_text("// v1\n")
    (tmp_path / "other.cuh").unlink()
    assert build.library_path("kern") == first
