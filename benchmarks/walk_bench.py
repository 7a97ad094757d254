"""On-device fast4 traceback walk: throughput + cross-check on one GPU.

Measures the production end-to-end alignment path at the bench headline
shape: streamed fast4 fill (dirs stay on device) -> batched device walk
(ops.traceback_device) -> 2-bit packed op fetch -> host decode/apply.
Compares against the legacy path's transfer bill (the full dirs tensor)
and cross-checks a sample of pairs against the host walker.

Usage: python benchmarks/walk_bench.py [n_pairs] [length] [sample]
Needs a GPU; exits non-zero without one.
"""

import sys
import time

import numpy as np

from _gpu import require_gpu


def main():
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    length = int(sys.argv[2]) if len(sys.argv) > 2 else 2046
    sample = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    print(require_gpu("walk_bench"), file=sys.stderr)
    import jax

    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu.ops.nw_affine_stream import (
        nw_affine_stream_batch,
    )
    from sequencealigning_tpu.ops.traceback import fast4_traceback_pair
    from sequencealigning_tpu.ops.traceback_device import (
        fast4_stream_align_device,
    )

    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(n_pairs):
        ref = rng.choice(list(b"ACGT"), length).astype(np.uint8).tobytes()
        mut = bytearray(ref)
        for _ in range(length // 100):
            p = int(rng.integers(0, len(mut)))
            mut[p] = int(rng.choice([c for c in b"ACGT" if c != mut[p]]))
        pairs.append((bytes(mut), ref))
    batch = trim_for_stream(pack_batch(pairs, batch_size=n_pairs))
    n1s = batch.query_len[:n_pairs]
    n2s = batch.db_len[:n_pairs]
    cells = float((n1s.astype(np.int64) * n2s.astype(np.int64)).sum())

    def fill():
        return nw_affine_stream_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            with_dirs="fast4",
            compat=True,
        )

    s1s = [p[0] for p in pairs]
    s2s = [p[1] for p in pairs]

    res = fill()  # compile + warm
    _ = np.asarray(res.finals)
    # Warm the walk+decode (compile) on the warm fill, then drop it: at
    # 4096 pairs the dirs tensor is ~8.6 GB and two live copies crowd the card.
    alns, scores = fast4_stream_align_device(
        res.dirs, res.finals, s1s, s2s, res.plan
    )
    res = None

    t0 = time.perf_counter()
    res = fill()
    _ = np.asarray(res.finals)
    t_fill = time.perf_counter() - t0

    t0 = time.perf_counter()
    alns, scores = fast4_stream_align_device(
        res.dirs, res.finals, s1s, s2s, res.plan
    )
    t_walk = time.perf_counter() - t0
    t_apply = 0.0  # decode to alignments is folded into the walk call

    n_fail = sum(a is None for a in alns)

    total = t_fill + t_walk + t_apply
    dirs_bytes = int(np.prod(res.dirs.shape)) * 4
    print(
        f"[walk] {n_pairs} x {length} bp: fill {t_fill*1e3:.1f} ms, "
        f"device walk+fetch+decode {t_walk*1e3:.1f} ms -> "
        f"{n_pairs/total:.0f} alignments/s "
        f"({cells/total/1e9:.1f} GCUPS e2e), walk failures: {n_fail}",
        file=sys.stderr,
    )
    print(
        f"[walk] transfer: packed ops ~{n_pairs*(res.plan.l1+res.plan.l2)//4/1e6:.1f} MB "
        f"vs dirs tensor {dirs_bytes/1e9:.2f} GB (legacy host walk path)",
        file=sys.stderr,
    )

    # Cross-check a sample against the host walker (fetch sampled rows only).
    import random

    random.seed(1)
    checked = 0
    for b in random.sample(range(n_pairs), min(sample, n_pairs)):
        if alns[b] is None:
            continue
        row, _slot, off = res.plan.pair_coords(b)
        dirs_row = np.asarray(res.dirs[:, row, :])
        want_score, want = fast4_traceback_pair(
            dirs_row, res.finals[b], pairs[b][0], pairs[b][1],
            compat=True, d_offset=off,
        )
        assert int(scores[b]) == want_score, (b, int(scores[b]), want_score)
        assert alns[b] == want[0], f"pair {b} alignment mismatch"
        checked += 1
    print(f"[walk] cross-check vs host walker: {checked} pairs OK",
          file=sys.stderr)
    import json

    print(json.dumps({
        "n_pairs": n_pairs, "length": length,
        "fill_ms": round(t_fill * 1e3, 1),
        "walk_ms": round(t_walk * 1e3, 1),
        "apply_ms": round(t_apply * 1e3, 1),
        "alignments_per_s": round(n_pairs / total, 1),
        "e2e_gcups": round(cells / total / 1e9, 2),
        "walk_failures": n_fail,
        "backend": jax.default_backend(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
