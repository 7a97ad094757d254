"""Time the fills that run as XLA-compiled lax.scan on the GPU.

These fills have no CUDA kernel: the plain per-pair Gotoh fill (runner
kernel="plain"), the plain and streamed textbook-modes fills, the
row-banded fill, and the tiled / row-folded long-pair fills.  Each is
timed warm at its configuration's width, ended with block_until_ready;
the numbers are what a CUDA version of each has to beat.  One JSON line
per fill after the card's name and power limit.  Needs a GPU; exits
non-zero without one.

    python benchmarks/lax_fills.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from _gpu import require_gpu


def _best(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    print(require_gpu("lax_fills"), flush=True)
    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu.ops.nw_affine_modes import nw_affine_modes_batch
    from sequencealigning_tpu.ops.nw_affine_stream_modes import (
        nw_affine_stream_modes_batch,
    )
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_batch,
        nw_affine_tiled_single,
    )
    from sequencealigning_tpu.ops.nw_banded import nw_banded_batch
    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.utils.synth import mutated_pairs

    rng = np.random.default_rng(0)

    def emit(name, batch, seconds, **kw):
        cells = float(np.sum(batch.query_len.astype(np.int64) *
                             batch.db_len))
        print(json.dumps(dict(fill=name, pairs=int(len(batch.query_len)),
                              seconds=seconds, gcups=cells / seconds / 1e9,
                              **kw)), flush=True)

    b2k = trim_for_stream(pack_batch(mutated_pairs(rng, 512, 2046),
                                     batch_size=512))
    plain = DataParallelRunner(kernel="plain")
    emit("plain_gotoh_scores", b2k, _best(lambda: plain.scores(b2k)),
         length=2046)
    for local in (False, True):
        mode = "local" if local else "semi"
        emit(f"plain_modes_{mode}", b2k, _best(lambda: nw_affine_modes_batch(
            b2k.query, b2k.db, b2k.query_len, b2k.db_len, local=local,
        ).best), length=2046)
        emit(f"stream_modes_{mode}", b2k, _best(
            lambda: nw_affine_stream_modes_batch(
                b2k.query, b2k.db, b2k.query_len, b2k.db_len, mode,
            ).best), length=2046)

    b5k = pack_batch(mutated_pairs(rng, 1024, 5115), batch_size=1024)
    for dirs in (False, "fast4", True):
        emit("row_banded", b5k, _best(lambda: nw_banded_batch(
            b5k.query, b5k.db, b5k.query_len, b5k.db_len, band=128,
            wildcard=True, with_dirs=dirs,
        ).finals, reps=1), length=5115, band=128, dirs=str(dirs))

    long = mutated_pairs(rng, 8, 20000)
    bl = pack_batch(long, batch_size=8)
    emit("tiled_scores", bl, _best(lambda: nw_affine_tiled_batch(
        bl.query, bl.db, bl.query_len, bl.db_len), reps=1), length=20000)
    q, d = long[0]
    one = pack_batch([(q, d)], batch_size=1)
    emit("folded_single", one, _best(
        lambda: nw_affine_tiled_single(q, d), reps=1), length=20000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
