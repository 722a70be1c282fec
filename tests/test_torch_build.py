"""The kernel builder (``chestxray_vit_tpu_torch/kernels``) with a stand-in
``nvcc``: one compiler process a source, each source's seconds kept in
``BUILD_SECONDS`` and the log, a failed source named in the error. The
real build runs only where the CUDA toolkit is (the card tests)."""

from __future__ import annotations

import os
import stat

import pytest

from chestxray_vit_tpu_torch import kernels

# A stand-in for nvcc: writes the file after -o (an object or the linked
# library), prints a line for the log, fails on FAIL_ON's source.
_FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift ;; *.cu) src="$1" ;; esac
  shift
done
if [ -n "$FAIL_ON" ] && [ "$(basename "$src")" = "$FAIL_ON" ]; then
  echo "error in $src"; exit 1
fi
echo "compiled $(basename "$src")"
touch "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_build_times_each_source_and_keeps_the_log(fake_toolkit):
    out = kernels.build()
    sources = [p.name for p in kernels._sources()]
    assert out.exists() and out.parent == fake_toolkit / "build"
    assert sorted(kernels.BUILD_SECONDS) == sorted(sources)
    seconds = list(kernels.BUILD_SECONDS.values())
    assert all(s >= 0 for s in seconds) and seconds == sorted(seconds,
                                                              reverse=True)
    log = out.with_suffix(".log").read_text()
    for name in sources:
        assert f"== {name} (" in log and f"compiled {name}" in log
    # no object is left beside the library
    assert sorted(os.listdir(out.parent)) == sorted([out.name,
                                                     out.stem + ".log"])


def test_build_names_the_source_that_failed(fake_toolkit, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "layer_norm_bwd.cu")
    with pytest.raises(RuntimeError, match=r"nvcc failed on "
                                           r"\['layer_norm_bwd.cu'\]"):
        kernels.build()
    assert not kernels.library_path().exists()
