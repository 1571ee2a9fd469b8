"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` (the hash is of the source, so an edited
source rebuilds).  Building happens at first use, or up front for every
source at once with :func:`build_all`.  Nothing here runs when the module is
imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "build_all"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: dict[str, str] = {}     # name -> nvcc's output (ptxas registers)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process or None, temp path, final path)."""
    src, lib = _target(name)
    if lib.exists():
        return None, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib


def _finish(name: str, proc, tmp: Path | None, lib: Path) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
    return lib


def build_all() -> list[Path]:
    """Compile every ``csrc/*.cu`` concurrently (one nvcc per source)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(n, *_start(n)) for n in names]
    return [_finish(*s) for s in started]


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
        return _libs[name]
