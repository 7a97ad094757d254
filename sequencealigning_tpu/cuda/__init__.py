"""Build, load and register the CUDA fills (fills.cu) as XLA FFI targets.

The library is compiled from the tracked sources beside this file with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/`` here (listed
in .gitignore), under a name keyed by a hash of the sources and flags, so
a changed source is rebuilt and a stale library is never loaded.  It is
built at first use; ``python -m sequencealigning_tpu.cuda`` builds it
ahead of time.  A failed build raises: a GPU run never falls back to the
``lax`` twins.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import jax

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "fills.cu",)
BUILD_DIR = _HERE / "build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", _ARCH)

# FFI target name -> exported handler symbol.
TARGETS = {
    "seqalign_stream_fill": "SeqalignStreamFill",
    "seqalign_banded_fill": "SeqalignBandedFill",
}

_lock = threading.Lock()
_registered = False
build_seconds = 0.0  # wall time of this process's build (0 if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA fills need the CUDA toolkit (nvcc on PATH "
        "or under /usr/local/cuda)"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libseqalign_cuda-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cmd = [
        _nvcc(), *_FLAGS, "-I", jax.ffi.include_dir(),
        *(str(s) for s in _SOURCES),
    ]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            cmd + ["-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed building the CUDA fills:\n"
                + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            )
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def ensure_registered() -> None:
    """Build (if needed), load and register every FFI target once."""
    global _registered
    if _registered:
        return
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for name, sym in TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)), platform="CUDA"
            )
        _registered = True
