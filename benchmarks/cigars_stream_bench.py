"""Steady-state full-alignment streaming: fill + device walk + decode.

Measured as a serial fill -> walk -> decode chain
(benchmarks/walk_bench) the device walk is a large share of e2e alignment
time.  The production path is the streaming pipeline, where the walk of batch k
overlaps the host prep/H2D of batch k+1 and the packed-op fetch + C
decode overlap the next fill.  This bench measures that: N pairs of
length L streamed through stream_align(cigars=True) in sub-batches sized
so two dirs tensors fit device memory, reporting sustained alignments/s.
Needs a GPU; exits non-zero without one.

Usage: python benchmarks/cigars_stream_bench.py [--pairs 4096]
       [--length 2046] [--batch 2048] [--out ""]
"""

from __future__ import annotations

import argparse
import json
import os as _os
import sys as _sys
import time

import numpy as np

from _gpu import require_gpu


def _mk_pairs(n_pairs, length, seed=7):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    refs = alpha[
        np.frombuffer(rng.bytes(n_pairs * length), np.uint8).reshape(
            n_pairs, length
        )
        & 3
    ]
    muts = refs.copy()
    n_mut = max(1, length // 100)
    rows = np.repeat(np.arange(n_pairs), n_mut)
    cols = rng.integers(0, length, n_pairs * n_mut)
    muts[rows, cols] = alpha[rng.integers(0, 4, n_pairs * n_mut)]
    return [
        (muts[i].tobytes(), refs[i].tobytes()) for i in range(n_pairs)
    ]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=4096)
    ap.add_argument("--length", type=int, default=2046)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    card = require_gpu("cigars_stream_bench")
    import jax

    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.parallel.streaming import stream_align
    N, L, B = args.pairs, args.length, args.batch

    pairs = _mk_pairs(N, L)

    def run_one(rle: bool):
        """One warm + one sustained pass; returns (rate dict)."""
        if rle:
            _os.environ["SEQALIGN_RLE"] = "1"
        else:
            _os.environ.pop("SEQALIGN_RLE", None)
        runner = DataParallelRunner()
        got = {"alns": 0, "fails": 0, "score_sum": 0, "drain_bytes": 0,
               "drain_path": ""}

        def on_alignments(idx, tbs):
            for t in tbs:
                if isinstance(t, tuple):
                    got["alns"] += 1
                    got["score_sum"] += t[0]
                else:
                    got["fails"] += 1
            got["drain_bytes"] += runner.last_drain_bytes
            got["drain_path"] = runner.last_drain_path

        # Warm (compile fill + walk + decode) on one sub-batch.
        stream_align(
            pairs[:B], runner=runner, batch_size=B, cigars=True,
            on_alignments=on_alignments,
        )
        got.update(alns=0, fails=0, score_sum=0, drain_bytes=0)

        t0 = time.perf_counter()
        n = stream_align(
            pairs, runner=runner, batch_size=B, cigars=True,
            on_alignments=on_alignments,
        )
        dt = time.perf_counter() - t0
        assert n == N and got["alns"] + got["fails"] == N, (n, got)
        cells = float(N) * L * L
        return {
            "seconds": round(dt, 2),
            "alignments_per_s": round(N / dt, 1),
            "e2e_gcups": round(cells / dt / 1e9, 2),
            "walk_failures": got["fails"],
            "drain_path": got["drain_path"],
            "drain_bytes_total": got["drain_bytes"],
            "drain_kb_per_batch": round(
                got["drain_bytes"] / max(1, -(-N // B)) / 1024, 1
            ),
            "score_sum": got["score_sum"],
        }

    result = {
        "pairs": N,
        "length": L,
        "batch": B,
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        "packed": run_one(rle=False),
        "rle": run_one(rle=True),
    }
    assert result["rle"]["score_sum"] == result["packed"]["score_sum"]
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    _sys.exit(main())
