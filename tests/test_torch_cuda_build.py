"""The CUDA build's library names: a hash of the source, the headers beside
it and the flags, so an edited kernel or shared header is rebuilt.  Needs
no nvcc: nothing is compiled."""
from repro_torch.kernels import cuda_build


def _tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "tile.cuh"\n')
    (src / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "_SRC_DIR", src)
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path / "build")
    return src


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    src = _tree(tmp_path, monkeypatch)
    first = cuda_build.library_path("a")
    assert first == cuda_build.library_path("a")
    (src / "tile.cuh").write_text("// v2\n")
    assert cuda_build.library_path("a") != first


def test_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    src = _tree(tmp_path, monkeypatch)
    first = cuda_build.library_path("a")
    monkeypatch.setitem(cuda_build.KERNEL_FLAGS, "a", ("-fmad=false",))
    flagged = cuda_build.library_path("a")
    assert flagged != first
    (src / "a.cu").write_text('#include "tile.cuh"\n// edited\n')
    assert cuda_build.library_path("a") not in (first, flagged)


def test_the_shared_header_is_built_with_both_pair_kernels():
    # both pair kernels include it and are built without contraction, so
    # the dense threshold and the packed bits share one arithmetic
    for name in ("nbr_adjacency", "pairdist"):
        text = (cuda_build._SRC_DIR / f"{name}.cu").read_text()
        assert '#include "pair_tile.cuh"' in text
        assert "-fmad=false" in cuda_build.KERNEL_FLAGS[name]
