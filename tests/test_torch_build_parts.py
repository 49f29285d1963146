"""A kernel source with more translation units (``<name>_parts/``): the
parts belong to its library, whose name hashes them and the headers they
include, and are no sources of their own. Nothing is compiled here (there
is no nvcc on the CPU machine)."""
import pytest

from paddle_tpu_torch.ops.kernels import _build


@pytest.fixture
def kernel_dir(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "k.cuh"\nint k;\n')
    (tmp_path / "k.cuh").write_text("#pragma once\n// one\n")
    (tmp_path / "k_parts").mkdir()
    (tmp_path / "k_parts" / "b.cu").write_text('#include "../k.cuh"\n')
    (tmp_path / "k_parts" / "a.cu").write_text('#include "../k.cuh"\n')
    (tmp_path / "j.cu").write_text("int j;\n")
    monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path)
    return tmp_path


def test_parts_are_no_sources_and_come_in_order(kernel_dir):
    assert _build.sources() == ["j", "k"]
    assert [p.name for p in _build.parts("k")] == ["a.cu", "b.cu"]
    assert _build.parts("j") == []


@pytest.mark.parametrize("edit", ["k_parts/a.cu", "k.cuh", "k.cu"])
def test_an_edited_part_or_shared_header_renames_the_library(kernel_dir,
                                                             edit):
    first = _build.library_path("k")
    other = _build.library_path("j")
    assert first == _build.library_path("k")
    path = kernel_dir / edit
    path.write_text(path.read_text() + "// two\n")
    assert _build.library_path("k") != first
    assert _build.library_path("j") == other


def test_the_paged_kernels_split_decode_instances_are_parts():
    """paged_attention.cu's 72 split decode instances: six parts, one
    (q, pool) pair each, instantiated there and declared extern in the
    main unit, so the main unit's nvcc compiles none of them."""
    names = [p.stem for p in _build.parts("paged_attention")]
    pairs = [(q, k) for q in ("bf16", "f32") for k in ("bf16", "f32",
                                                      "int8")]
    assert names == [f"split_{q}_{k}" for q, k in pairs]
    main = (_build.KERNEL_DIR / "paged_attention.cu").read_text()
    assert main.count("extern template cudaError_t split_by_dim<") == 6
    for part in _build.parts("paged_attention"):
        text = part.read_text()
        assert text.count("template cudaError_t split_by_dim<") == 1
        assert '#include "../paged_attention.cuh"' in text
    assert "paged_attention" not in [p.split("_parts")[0]
                                     for p in _build.sources()
                                     if "_parts" in p]
