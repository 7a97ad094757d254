"""The benchmark scripts' shared guard: they measure on a GPU or not at all."""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def require_gpu(name: str) -> str:
    """Exit non-zero (printing no result) unless JAX runs on a GPU; turn
    the persistent compile cache on; return the card's name and power
    limit as nvidia-smi reports them."""
    import jax

    from sequencealigning_tpu.utils.compilecache import enable

    if jax.default_backend() != "gpu":
        print(f"{name}: JAX found no GPU; nothing measured", file=sys.stderr)
        sys.exit(2)
    enable()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
