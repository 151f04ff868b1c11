# The port's kernel build cache (spark_rapids_ml_tpu_torch/ops/_build.py): a
# library is keyed by its source, the local headers that source includes
# (directly or through another header) and the nvcc flags, so an edit to an
# included header builds anew instead of loading a stale library.  Needs no
# nvcc: library_path only hashes files.
import pytest

from spark_rapids_ml_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include <cstdint>\n#include "tile.cuh"\nint f() { return g(); }\n')
    (tmp_path / "tile.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint g() { return h(); }\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("#pragma once\ninline int u() { return 2; }\n")
    return tmp_path


def test_sources_follow_local_includes(csrc):
    assert sorted(_build._sources("kern")) == ["inner.cuh", "kern.cu", "tile.cuh"]


@pytest.mark.parametrize("edited", ["kern.cu", "tile.cuh", "inner.cuh"])
def test_an_edit_to_the_source_or_an_included_header_changes_the_library(csrc, edited):
    before = _build.library_path("kern")
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    after = _build.library_path("kern")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("libkern-")


def test_a_header_the_source_does_not_include_leaves_the_library(csrc):
    before = _build.library_path("kern")
    (csrc / "other.cuh").write_text("#pragma once\ninline int u() { return 3; }\n")
    assert _build.library_path("kern") == before


def test_the_port_sources_that_share_the_tile_loop_hash_its_header():
    for name in ("min_dist_argmin", "knn_topm"):
        assert "fp32_dist_tile.cuh" in _build._sources(name)
