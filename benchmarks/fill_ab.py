"""Tuning sweep of the CUDA fills against their lax.scan twins, one GPU.

Checks each fill bit for bit against its twin on small shapes (every
dirs mode, single- and multi-warp blocks), then, with --sweep, times the
streamed fill at 4096 x 2 kb over pipeline depth (np_slots) and lanes per
thread, and the banded fill at 1024 x 5 kb over lanes per thread.  Each
record is one JSON line on stdout and in --out, after the card's name and
power limit.  Needs a GPU; exits non-zero without one.

    python benchmarks/fill_ab.py [--sweep]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import banded_kernel_vs_twin, stream_kernel_vs_twin  # noqa


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out/fill_ab.jsonl"))
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("fill_ab: JAX found no GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    from sequencealigning_tpu.ops import nw_banded_diag as nd
    from sequencealigning_tpu.utils.synth import mutated_pairs

    rng = np.random.default_rng(args.seed)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    fails = 0
    with open(args.out, "a") as fh:
        def emit(rec, **extra):
            nonlocal fails
            rec.update(extra)
            line = json.dumps(rec)
            print(line, flush=True)
            fh.write(line + "\n")
            fails += rec.get("finals_equal") is False
            fails += rec.get("dirs_equal") is False

        for n, length in ((64, 300), (48, 700)):
            pairs = mutated_pairs(rng, n, length)
            for dm in (False, "fast4", "full"):
                emit(stream_kernel_vs_twin(pairs, dm, np_slots=4, reps=1),
                     fill="stream")
        for dm in (False, "fast4", "full"):
            emit(banded_kernel_vs_twin(mutated_pairs(rng, 16, 700), 64, dm,
                                       reps=1), fill="banded_diag")
        for length, band in ((3000, 600), (9000, 2048), (9000, 4096)):
            emit(banded_kernel_vs_twin(mutated_pairs(rng, 8, length), band,
                                       "fast4", reps=1), fill="banded_diag")
        if args.sweep:
            big = mutated_pairs(rng, 4096, 2046)
            for nps in (4, 8, 16, 32):
                for lpt in (4, 8):
                    emit(stream_kernel_vs_twin(big, "fast4", np_slots=nps,
                                               lpt=lpt, twin=False),
                         fill="stream")
            band_pairs = mutated_pairs(rng, 1024, 5115)
            default = nd.banded_lanes_per_thread
            try:
                for lpt in (4, 8, 16):
                    nd.banded_lanes_per_thread = lambda L, lpt=lpt: lpt
                    nd._jitted_diag.cache_clear()
                    emit(banded_kernel_vs_twin(band_pairs, 128, "fast4",
                                               twin=False),
                         fill="banded_diag", lpt=lpt)
            finally:
                nd.banded_lanes_per_thread = default
                nd._jitted_diag.cache_clear()
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
