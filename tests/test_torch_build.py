"""ops/_build.py: how the port's CUDA sources are built at first use.

There is no nvcc on a CPU-only machine, so a stand-in `nvcc` script
(CUDA_HOME/bin/nvcc) records its arguments and writes the output file;
the real build runs on the card (chip_smoke.py). Checked here: the
library name follows the content hash, every source gets its own nvcc
process with the Hopper flags, an unchanged source is not rebuilt, and a
failed build raises with the compiler's output.
"""
import ctypes
import os
import stat

import pytest

from paddle_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$@" >> "$(dirname "$0")/calls.txt"
case "$*" in
  *broken.cu*) echo "broken.cu(3): error: expected a ';'"; exit 2;;
esac
echo "ptxas info    : Used 40 registers, 0 bytes spill stores"
echo lib > "$out"
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return home, csrc


def test_builds_every_source_with_hopper_flags(fake_cuda):
    home, csrc = fake_cuda
    info = _build.build()
    assert sorted(info) == ["a", "b"]
    assert all(not i["cached"] and "registers" in i["log"]
               for i in info.values())
    calls = (home / "bin" / "calls.txt").read_text().splitlines()
    assert len(calls) == 2
    for c in calls:
        assert "arch=compute_90a,code=sm_90a" in c and "-shared" in c
        assert "-Xcompiler -fPIC" in c and "-O3" in c
    for name in ("a", "b"):
        assert _build.library_path(name).exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    # nothing changed: loaded from disk, no new nvcc
    again = _build.build()
    assert all(i["cached"] for i in again.values())
    assert len((home / "bin" / "calls.txt").read_text().splitlines()) == 2


def test_source_or_header_change_rebuilds(fake_cuda):
    _, csrc = fake_cuda
    before = _build.library_path("a")
    (csrc / "a.cu").write_text("// a, edited\n")
    edited = _build.library_path("a")
    (csrc / "common.cuh").write_text("// shared header\n")
    assert len({before, edited, _build.library_path("a")}) == 3


def test_failed_build_raises_with_compiler_output(fake_cuda):
    _, csrc = fake_cuda
    (csrc / "broken.cu").write_text("int x\n")
    with pytest.raises(RuntimeError, match="expected a ';'"):
        _build.build(["broken", "a"])
    assert not _build.library_path("broken").exists()
    assert _build.library_path("a").exists()
    assert not list(_build.BUILD_DIR.glob("*.tmp.so"))


def test_missing_nvcc_and_unknown_source(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else os.path.lexists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    with pytest.raises(FileNotFoundError):
        _build.build(["no_such_kernel"])


def test_repo_sources_are_listed():
    assert "flash_attn_fwd" in _build.sources()
    assert _build.library_path("flash_attn_fwd").name.startswith(
        "flash_attn_fwd-")


def test_backward_and_philox_sources_are_built():
    assert {"flash_attn_fwd", "flash_attn_bwd"} <= set(_build.sources())
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert {"philox.cuh", "flash_common.cuh", "hopper.cuh"} <= headers
    for src in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        text = (_build.CSRC / src).read_text()
        assert '#include "philox.cuh"' in text
    assert '#include "hopper.cuh"' in (
        _build.CSRC / "flash_attn_bwd.cu").read_text()


@pytest.mark.parametrize("src", ["flash_attn_fwd.cu", "flash_attn_bwd.cu"])
def test_bf16_kernels_share_the_wgmma_pipeline(src):
    """The bf16 forward and backward are built on one pipeline header
    (ring, barriers, products, keep bits, work items); no mma.sync,
    ldmatrix or cp.async kernel code is left in the sources."""
    text = (_build.CSRC / src).read_text()
    assert '#include "flash_wgmma.cuh"' in text
    assert "_wgmma<" in text
    for p in sorted(_build.CSRC.glob("*.cu*")):
        for instr in ("mma.sync.aligned", "ldmatrix", "cp.async.cg"):
            assert instr not in p.read_text(), (p.name, instr)


def test_package_data_ships_every_source_and_header():
    """An installed package compiles from its own csrc/: every source
    and every header a source includes must be in package-data."""
    import fnmatch
    import re
    import tomllib
    root = _build.CSRC.parents[1]
    with open(root / "pyproject.toml", "rb") as f:
        shipped = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "paddle_tpu_torch"]
    files = sorted(_build.CSRC.glob("*.cu")) + sorted(
        _build.CSRC.glob("*.cuh"))
    needed = {p.name for p in files}
    for p in files:
        needed |= set(re.findall(r'#include "([^"]+)"', p.read_text()))
    assert {"philox.cuh", "flash_common.cuh"} <= needed
    for name in sorted(needed):
        assert (_build.CSRC / name).is_file(), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", pat) for pat in shipped), \
            f"csrc/{name} is not in paddle_tpu_torch's package-data"


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "float*": ctypes.c_void_p, "const float*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "unsigned int": ctypes.c_uint, "float": ctypes.c_float}


@pytest.mark.parametrize("entry", ["pt_flash_attn_fwd",
                                   "pt_flash_attn_bwd_dq",
                                   "pt_flash_attn_bwd_dkv",
                                   "pt_flash_attn_fwd_wg256",
                                   "pt_flash_attn_bwd_dq_wg256",
                                   "pt_flash_attn_bwd_dkv_wg256",
                                   "pt_flash_attn_fwd_wgwide",
                                   "pt_flash_attn_bwd_dq_wgwide",
                                   "pt_flash_attn_bwd_dkv_wgwide",
                                   "pt_flash_attn_fwd_wide",
                                   "pt_flash_attn_bwd_dq_wide",
                                   "pt_flash_attn_bwd_dkv_wide",
                                   "pt_flash_attn_bwd_dq_d256",
                                   "pt_flash_attn_bwd_dkv_d256"])
def test_ctypes_signatures_match_the_c_entries(entry):
    """The wrappers' argtypes against the extern "C" parameter lists, so
    a marshalling slip shows here and not only on the card."""
    import re
    from paddle_tpu_torch.ops import flash_attention as fa
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text, re.S)
    assert m, entry
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    kinds = [_C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
             for p in params]
    assert kinds == fa._ARGTYPES[entry]


def test_every_argtypes_entry_is_a_c_entry():
    """Every entry the wrappers know the argtypes of is an extern "C"
    entry of csrc/ (the f32 forward at 256 is flash_attn_wide.cu's, so
    flash_attn_d256.cu has no forward entry), and back."""
    import re
    from paddle_tpu_torch.ops import flash_attention as fa
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    entries = set(re.findall(r'extern "C" int (pt_flash_attn\w*)\(', text))
    assert entries == set(fa._ARGTYPES)
    assert "pt_flash_attn_fwd_d256" not in entries
