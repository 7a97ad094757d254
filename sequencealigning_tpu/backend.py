"""The one place that maps the JAX platform to a fill engine and settings.

* ``cpu`` runs every fill as its ``lax.scan`` twin (the plain reference
  the tests pin against the scalar oracles).
* ``gpu`` runs the CUDA fills (sequencealigning_tpu.cuda) for the kernels
  in CUDA_MAX_LANES, on rows up to the kernel's lane limit, and the
  ``lax`` twin for every wider row and every other fill.
* Any other platform raises.

The ``backend=`` argument of the two fills with a CUDA kernel is the
explicit A/B switch: "auto" resolves here, "lax" forces the twin, "cuda"
forces the kernel (and raises on a row it cannot hold).  Every other fill
has the twin only and takes no such argument.
"""

from __future__ import annotations

import jax

# Widest row (lanes) each CUDA fill holds in registers (cuda/fills.cu):
# * "stream" (ops.nw_affine_stream): P lanes over one block of at most
#   1024 threads x 4 lanes or 512 x 8, the limit at which its 7 int32
#   state arrays stop spilling (16 lanes a thread spilled);
# * "banded_diag" (ops.nw_banded_diag): 384 threads x 16 lanes, its launch
#   bound at 16 lanes a thread (where the dirs variants already spill a
#   few registers).
# A wider row -- a 4-49 kb db in the streamed fill, the WFA std route's
# full-width band round on long pairs -- runs the lax twin under "auto"
# (its card time is in PERF.md).
CUDA_MAX_LANES = {"stream": 4096, "banded_diag": 6144}

SUPPORTED_PLATFORMS = ("cpu", "gpu")


def platform() -> str:
    """The default JAX platform, checked against the supported ones."""
    p = jax.default_backend()
    if p not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this package runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}"
        )
    return p


def engine(kernel: str, backend: str = "auto", lanes: int = 0) -> str:
    """Resolve the ``backend=`` argument of a fill with a CUDA kernel to
    "lax" or "cuda" for a row of ``lanes`` lanes (0: width not known
    yet, validate the request only)."""
    if kernel not in CUDA_MAX_LANES:
        raise ValueError(f"the {kernel} fill has no engine choice")
    fits = lanes <= CUDA_MAX_LANES[kernel]
    if backend == "auto":
        return "cuda" if platform() == "gpu" and fits else "lax"
    if backend == "cuda" and not fits:
        raise ValueError(
            f"a row of {lanes} lanes exceeds the CUDA {kernel} fill's "
            f"{CUDA_MAX_LANES[kernel]}"
        )
    if backend in ("lax", "cuda"):
        return backend
    raise ValueError(f"unknown backend {backend!r} for the {kernel} fill")


def banded_walk_setting() -> tuple:
    """(substeps, unroll) of the banded device walk
    (ops.traceback_device._walk_banded_diag_msub).  The CPU keeps
    substeps * unroll <= 2: its compile time explodes past ~3 inlined
    plane-steps per scan body.  The GPU value was chosen by timing both
    settings in chip_smoke.py's banded phase (PERF.md)."""
    return (4, 2) if platform() == "gpu" else (2, 1)
