"""The kernels' build cache (``psvi_torch/ops/_build.py``): a library's path
hashes its source, the headers of ``csrc/`` it includes and the flags, so an
edited header rebuilds every library that includes it and no other. Nothing
is compiled here: ``library_path`` only reads the sources."""

import shutil

import pytest

from psvi_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build module reads in place of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    return copy


def test_the_forward_sources_include_the_shared_header(csrc):
    for name in ("sampled_linear", "sampled_linear_prng"):
        assert [p.name for p in _build._local_headers(csrc / f"{name}.cu")] == [
            "sampled_linear_gemm.cuh"]
    assert _build._local_headers(csrc / "fused_nested.cu") == []


@pytest.mark.parametrize("edited", ["sampled_linear_gemm.cuh", "sampled_linear.cu"])
def test_an_edited_source_or_header_changes_the_library_path(csrc, edited):
    names = ("sampled_linear", "sampled_linear_prng", "fused_nested", "fused_lenet")
    before = {n: _build.library_path(n) for n in names}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    changed = {n for n in names if after[n] != before[n]}
    want = {"sampled_linear", "sampled_linear_prng"} if edited.endswith(".cuh") else {
        "sampled_linear"}
    assert changed == want
    assert all(p.parent == _build._BUILD for p in after.values())


def test_a_header_included_by_a_header_counts(csrc):
    (csrc / "inner.cuh").write_text("// inner\n")
    with open(csrc / "sampled_linear_gemm.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    before = _build.library_path("sampled_linear")
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    assert _build.library_path("sampled_linear") != before
