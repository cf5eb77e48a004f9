"""The port's CUDA build (kernels/build.py): which library a source maps to.

Nothing is compiled here (the CPU has no nvcc); the digest in the library's
file name is what decides whether an edited source or header builds anew.
"""

from styletts2_tpu_torch.kernels import build


def test_library_path_follows_source_headers_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint k() { return 1; }\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.sources() == ["k"]                  # headers are not compiled alone
    first = build.library_path("k")
    assert build.library_path("k") == first
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk-")

    (tmp_path / "h.cuh").write_text("// v2\n")       # an edited header
    second = build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")  # a new header
    third = build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint k() { return 2; }\n')
    fourth = build.library_path("k")
    assert fourth not in (first, second, third)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != fourth


def test_every_kernel_source_is_built():
    assert build.sources() == ["adain_snake", "maximum_path", "mrf_round"]
    assert (build.CSRC / "tf32_wgmma.cuh").is_file()
    assert (build.CSRC / "bf16_wgmma.cuh").is_file()
