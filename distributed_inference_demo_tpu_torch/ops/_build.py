"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, named by a hash of the
source, every header under ``csrc/`` (a source may include any of them)
and the flags, and loaded with ``ctypes``.  A library already built from
the same bytes is reused, and nvcc's output (the ptxas register and
spill report) is kept beside it as ``<name>-<hash>.log``, so
``build_logs`` holds it whether the library was built now or before.  A
failed build raises: there is no fallback that hides a missing kernel.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}   # source name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: the name
    hashes the source, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library already exists; either
    way ``build_logs[source]`` holds the build's nvcc output."""
    out = library_path(source)
    log = out.with_suffix(".log")
    if out.exists():
        build_logs[source] = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} "
                           f"(exit {proc.returncode}):\n{build_logs[source]}")
    # the log first: a loader that sees the library finds its log too
    tmp_log = log.with_suffix(f".{os.getpid()}.logtmp")
    tmp_log.write_text(build_logs[source])
    os.replace(tmp_log, log)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build(source)))
        return lib
