"""Build the port's CUDA sources at first use and load them with ctypes.

Each `paddle_tpu_torch/csrc/<name>.cu` has a plain C interface and
compiles on its own with nvcc for Hopper (sm_90a) into
`build/paddle_tpu_torch/<name>-<hash>.so` at the root of the checkout
(`build/` is git-ignored). The hash covers the source, every shared
header in csrc/ and the flags, so an edited source rebuilds and an
unchanged one loads from disk. build() starts one nvcc per source, all
at once, and waits for all of them; a failed build raises with nvcc's
output. Nothing here runs at import: the CPU tests import every module
on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of paddle_tpu_torch are built from source at first use")


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile `names` (default: every csrc/*.cu) that are not built yet,
    one nvcc process each, all started together. Returns
    {name: {"seconds", "cached", "log"}}, where log is nvcc's output
    (ptxas register and spill counts)."""
    names = list(names) if names is not None else sources()
    for name in names:
        if not (CSRC / f"{name}.cu").exists():
            raise FileNotFoundError(f"no CUDA source {CSRC / (name + '.cu')}")
    info = {}
    todo = []
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            info[name] = {"seconds": 0.0, "cached": True,
                          "log": log.read_text() if log.exists() else ""}
        else:
            todo.append((name, out))
    if not todo:
        return info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(f".{os.getpid()}.log"), "w+")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, t0, proc in procs:
        rc = proc.wait()
        secs = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        os.unlink(log.name)
        if rc != 0 or not tmp.exists():
            failed.append(f"--- nvcc {name}.cu (exit {rc}) ---\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
        info[name] = {"seconds": secs, "cached": False, "log": text}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
