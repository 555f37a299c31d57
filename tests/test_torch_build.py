"""The kernel build's library naming (no nvcc needed).

A library is reused only when it was built from the same bytes: the
name hashes the ``.cu`` source, every ``csrc/*.cuh`` header it may
include, and the flags (a ``-D`` define among them).
"""

import pytest

from distributed_inference_demo_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\nint k;\n')
    (tmp_path / "tile.cuh").write_text("int tile = 1;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_header_bytes_change_the_library_path(csrc):
    before = _build.library_path("k.cu")
    assert _build.library_path("k.cu") == before
    (csrc / "tile.cuh").write_text("int tile = 2;\n")
    changed = _build.library_path("k.cu")
    assert changed != before and changed.name.startswith("k-")
    (csrc / "more.cuh").write_text("int more;\n")
    assert _build.library_path("k.cu") != changed


@pytest.mark.parametrize("edit", ["source", "defines"])
def test_source_and_defines_change_the_library_path(csrc, monkeypatch,
                                                     edit):
    before = _build.library_path("k.cu")
    if edit == "source":
        (csrc / "k.cu").write_text('#include "tile.cuh"\nint k2;\n')
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ["-DEXTRA=1"])
    assert _build.library_path("k.cu") != before
