"""The port's kernel build module (``theanompi_tpu_torch.cuda_build``)
without a CUDA toolkit: a stand-in compiler script checks what the
module does around ``nvcc`` — one process per missing library, a
library name that follows the source, atomic publication, the ptxas log
kept, and a failed build that raises with the compiler's output and
leaves nothing behind."""

import os
import stat

import pytest

from theanompi_tpu_torch import cuda_build

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: log the call, fail on request, else write -o target
echo "$@" >> "{calls}"
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
case "$*" in
  *broken.cu*) echo "broken.cu(1): error: expected a ';'"; exit 2 ;;
esac
echo "ptxas info    : Used 32 registers, used 1 barriers"
echo built > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    calls = tmp_path / "calls.txt"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "broken.cu").write_text("int x\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return csrc, calls


def _n_calls(calls):
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_build_compiles_each_missing_library_once(fake_toolchain):
    csrc, calls = fake_toolchain
    paths = cuda_build.build(["a", "b"])
    assert _n_calls(calls) == 2
    for name, path in paths.items():
        assert path.read_text() == "built\n"
        assert path.name.startswith(f"lib{name}-")
        log = path.with_name(path.name + ".log").read_text()
        assert "registers" in log
    assert "sm_90a" in calls.read_text()
    # built libraries are reused; nothing half-written is left around
    assert cuda_build.build(["a", "b"]) == paths
    assert _n_calls(calls) == 2
    assert not [p for p in cuda_build.BUILD_DIR.iterdir()
                if p.name.endswith(".tmp")]


def test_edited_source_gets_a_new_library(fake_toolchain):
    csrc, calls = fake_toolchain
    before = cuda_build.library_path("a")
    (csrc / "a.cu").write_text("// a, edited\n")
    after = cuda_build.library_path("a")
    assert after != before
    (csrc / "common.cuh").write_text("// shared header\n")
    assert cuda_build.library_path("a") != after


def test_failed_build_raises_with_compiler_output(fake_toolchain):
    with pytest.raises(RuntimeError, match="expected a ';'"):
        cuda_build.build(["a", "broken"])
    # the good library still landed; the broken one left nothing
    names = sorted(p.name for p in cuda_build.BUILD_DIR.iterdir())
    assert any(n.startswith("liba-") and n.endswith(".so") for n in names)
    assert not any("broken" in n for n in names)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a real toolkit is installed at /usr/local/cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()
