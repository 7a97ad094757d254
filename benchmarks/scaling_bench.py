"""Data-parallel weak-scaling harness (BASELINE config-5 efficiency metric).

Measures pairs/s and efficiency vs the 1-GPU mesh at each device count
of the host's GPUs (weak scaling: the batch grows with the mesh), and
writes them to --out.  Needs a GPU; exits non-zero without one.

    python benchmarks/scaling_bench.py [--out scaling.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


from _gpu import require_gpu


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="scaling.json")
    ap.add_argument("--pairs-per-device", type=int, default=512)
    ap.add_argument("--length", type=int, default=1023)
    args = ap.parse_args()

    card = require_gpu("scaling_bench")
    import jax

    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.parallel.mesh import make_mesh
    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.utils.timing import scaling_efficiency

    per_dev = args.pairs_per_device
    length = args.length
    nd_all = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= nd_all]

    rng = np.random.default_rng(7)

    def mk_batch(n_pairs):
        pairs = []
        for _ in range(n_pairs):
            ref = rng.choice(list(b"ACGT"), length).astype(np.uint8).tobytes()
            pairs.append((ref, ref))
        return pack_batch(pairs, batch_size=n_pairs)

    batches = {n: mk_batch(n * per_dev) for n in counts}

    def make_runner(n):
        mesh = make_mesh((n,), ("data",), devices=jax.devices()[:n])
        return DataParallelRunner(mesh=mesh)

    results = scaling_efficiency(
        make_runner, lambda n: batches[n], counts, n_iter=3
    )
    out = {
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        "pairs_per_device": per_dev,
        "length": length,
        "results": {str(k): v for k, v in results.items()},
    }
    for n, r in results.items():
        print(
            f"[scaling] {n} dev: {r['pairs_per_s']:.1f} pairs/s, "
            f"efficiency {r['efficiency']:.2%}",
            file=sys.stderr,
        )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
