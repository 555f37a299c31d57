"""Build the native comm library (codec + tokenizer) with g++.

The sources are plain C ABI files loaded with ``ctypes``.  At first use
they are compiled into one shared library under ``build/native/`` at the
root of the checkout, named by a hash of the sources and the flags (as
``ops/_build.py`` names the kernels), so a library built from the same
bytes is reused and nothing is written beside the sources.  A failed
build raises with the compiler's output.  ``python -m
distributed_inference_demo_tpu_torch.comm.native.build`` builds it and
prints its path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("codec.cc", "tokenizer.cc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-Wall"]

_lock = threading.Lock()


def lib_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdwt_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it already exists; returns its path.
    Raises ``RuntimeError`` with g++'s output when the build fails."""
    out = lib_path()
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               *[str(SRC_DIR / s) for s in SOURCES]]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build: cannot run g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed (g++ exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        return out


if __name__ == "__main__":
    path = build()
    print(f"built {path} ({os.path.getsize(path)} bytes)")
