"""Measure the textbook semi-global/local engines on one GPU.

Compares the plain per-pair modes kernel (ops.nw_affine_modes) against
the streamed-pair modes engine (ops.nw_affine_stream_modes) at a
config-2-scaled shape.  End-to-end per call (host batch in, device
argmax buffers out, forced read), GCUPS counts true n1*n2 cells.  Both
run their lax.scan fills (no CUDA modes kernel yet); the numbers are the
bar a modes mode of the CUDA streamed fill has to beat.  Needs a GPU;
exits non-zero without one.

Usage: python benchmarks/modes_bench.py [--pairs 512] [--length 2046]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from _gpu import require_gpu


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=512)
    ap.add_argument("--length", type=int, default=2046)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--with-dirs", action="store_true", default=True)
    args = ap.parse_args()

    card = require_gpu("modes_bench")
    print(card, file=sys.stderr)
    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu.ops.nw_affine_modes import nw_affine_modes_batch
    from sequencealigning_tpu.ops.nw_affine_stream_modes import (
        nw_affine_stream_modes_batch,
    )

    from sequencealigning_tpu.utils.synth import mutated_pairs

    rng = np.random.default_rng(11)
    pairs = mutated_pairs(rng, args.pairs, args.length)
    batch = trim_for_stream(pack_batch(pairs, batch_size=args.pairs))
    cells = float(
        (batch.query_len.astype(np.int64) * batch.db_len.astype(np.int64)).sum()
    )

    out = []
    for mode in ("semi", "local"):
        for engine in ("stream", "plain"):
            try:
                def run():
                    if engine == "stream":
                        r = nw_affine_stream_modes_batch(
                            batch.query, batch.db,
                            batch.query_len, batch.db_len, mode,
                            with_dirs=args.with_dirs,
                            np_slots=max(1, min(8, args.pairs // 8)),
                        )
                        return r.best  # already np (reduced on device)
                    r = nw_affine_modes_batch(
                        batch.query, batch.db,
                        batch.query_len, batch.db_len,
                        local=(mode == "local"),
                        with_dirs=args.with_dirs,
                    )
                    return np.asarray(r.best)

                t0 = time.perf_counter()
                run()
                compile_s = time.perf_counter() - t0
                dt = float("inf")
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    run()
                    dt = min(dt, time.perf_counter() - t0)
                row = {
                    "mode": mode, "engine": engine,
                    "gcups": round(cells / dt / 1e9, 2),
                    "ms": round(dt * 1e3, 2),
                    "compile_s": round(compile_s, 1),
                }
            except Exception as ex:
                row = {
                    "mode": mode, "engine": engine,
                    "error": f"{type(ex).__name__}: {str(ex)[:160]}",
                }
            out.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
