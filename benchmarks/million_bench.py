"""Stream ONE MILLION read pairs through the data-parallel runner.

BASELINE config 5 names "1M read pairs streamed data-parallel"; this
actually runs it (scores path) on every local GPU's mesh, exercising
the bounded
in-flight window, the batch-cursor checkpoint, and sustained-throughput
behavior at scale (not a projection).  Pairs are generated batch-wise
with vectorized NumPy so input synthesis never becomes the bottleneck,
and a mid-run resume is exercised by re-invoking stream_align with the
checkpoint file after a simulated interruption.  Needs a GPU; exits
non-zero without one.

Usage: python benchmarks/million_bench.py [--pairs 1000000]
       [--length 1022] [--batch 4096] [--out million.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from _gpu import require_gpu


def _batch_stream(n_total: int, length: int, batch: int, seed: int = 9):
    """Yield pre-packed WireBatch objects (~1% substitutions): the whole
    input path is vectorized NumPy (io.encode.pack_wire, fused ASCII ->
    2-bit wire), no per-pair Python loop anywhere between synthesis and
    the device."""
    from sequencealigning_tpu.io.encode import pack_wire

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    done = 0
    while done < n_total:
        n = min(batch, n_total - done)
        # rng.bytes + &3 is ~2x cheaper than rng.integers at this size.
        raw = np.frombuffer(rng.bytes(n * length), np.uint8).reshape(n, length)
        refs = alpha[raw & 3]
        muts = refs.copy()
        n_mut = max(1, length // 100)
        rows = np.repeat(np.arange(n), n_mut)
        cols = rng.integers(0, length, n * n_mut)
        muts[rows, cols] = alpha[rng.integers(0, 4, n * n_mut)]
        lens = np.full(n, length, np.int32)
        yield pack_wire(muts, refs, lens, lens, batch_size=batch)
        done += n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--length", type=int, default=1022)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    card = require_gpu("million_bench")
    import jax

    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.parallel.streaming import stream_align
    n_total = args.pairs
    batch = args.batch

    runner = DataParallelRunner()
    ckpt = os.path.join(tempfile.mkdtemp(), "cursor.json")
    got = {"batches": 0, "pairs": 0, "score_sum": 0}

    def on_result(idx, scores):
        got["batches"] += 1
        got["pairs"] += len(scores)
        got["score_sum"] += int(scores.max(axis=1).sum())

    # Warm compile outside the timed run.
    stream_align(
        _batch_stream(batch, args.length, batch), runner=runner,
        batch_size=batch,
    )

    # Leg 1: interrupt after ~1/4 of the batches (checkpoint exercises
    # resume exactly like a preempted production run).
    n_first = (n_total // batch) // 4 * batch
    t0 = time.perf_counter()
    stream_align(
        _batch_stream(n_first, args.length, batch), runner=runner,
        batch_size=batch, checkpoint_path=ckpt, on_result=on_result,
    )
    with open(ckpt) as f:
        resumed_from = json.load(f)["next_batch"]
    # Leg 2: production-style resume -- the input reader seeks past the
    # completed batches (first_batch_index) instead of regenerating and
    # discarding them; the checkpoint cursor still guards correctness.
    stream_align(
        _batch_stream(n_total - resumed_from * batch, args.length, batch),
        runner=runner, batch_size=batch, checkpoint_path=ckpt,
        on_result=on_result, first_batch_index=resumed_from,
    )
    dt = time.perf_counter() - t0

    ok = got["pairs"] >= n_total  # final partial batch pads upward
    result = {
        "pairs": n_total,
        "length": args.length,
        "batch": batch,
        "seconds": round(dt, 2),
        "pairs_per_s": round(n_total / dt, 1),
        "gcups": round(n_total * args.length * args.length / dt / 1e9, 2),
        "resumed_from_batch": resumed_from,
        "batches_delivered": got["batches"],
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        # Input contract: this bench streams PRE-PACKED 2-bit WireBatch
        # objects (io.encode wire format, scores only) -- the
        # zero-host-prep fast path.  The byte-pair path (host pack per
        # batch) is chip_smoke.py's streaming phase.
        "input_contract": "prepacked-2bit-wire, scores only",
        "ok": bool(ok),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
