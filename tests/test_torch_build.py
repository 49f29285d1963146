"""The port's kernel build: a library is named by a hash of its source,
of the headers that source includes and of the flags, so that an edited
header builds a new library and a stale one is never loaded. Nothing is
compiled here (there is no nvcc on the CPU machine)."""
from paddle_tpu_torch.ops.kernels import _build


def test_an_edited_header_renames_the_library(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n'
                                   "int k;\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")      # stable while unchanged
    (tmp_path / "b.cuh").write_text("// two\n")   # a header of a header
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n//\n')
    assert _build.library_path("k") not in (first, second)


def test_both_attention_sources_hash_the_shared_header():
    header = (_build.KERNEL_DIR / "flash_tiles.cuh").read_bytes()
    for name in ("flash_attention_gqa", "splash_attention"):
        text = _build._with_headers(_build.KERNEL_DIR / f"{name}.cu", set())
        assert header in text, name
    assert "flash_tiles" not in _build.sources()   # a header, not a source
