"""Benchmark: streamed Gotoh fill throughput on one GPU.

Workload: BASELINE config 2's pairs at headline scale -- 4096 pairs of
~2 kb DNA at ~1% divergence (utils.synth), generated from --seed.  Times the
production entry, DataParallelRunner's fused fast4 fill + device walk
(what GotohAligner(first_only=True) dispatches), and its score-only
fill, each warm and ended with block_until_ready.  GCUPS counts only the
true n1*n2 cells of each pair.

Needs a GPU: with none it exits non-zero and prints no result.  Prints
the card's name and power limit, then ONE JSON line on stdout.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from sequencealigning_tpu.utils.compilecache import enable as _enable_cache


def _best(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=4096)
    ap.add_argument("--length", type=int, default=2046)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("bench.py: no GPU found; nothing measured", file=sys.stderr)
        return 2
    _enable_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)

    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.utils.synth import mutated_pairs

    rng = np.random.default_rng(args.seed)
    pairs = mutated_pairs(rng, args.pairs, args.length)
    batch = trim_for_stream(pack_batch(pairs, batch_size=len(pairs)))
    cells = float(
        np.sum(batch.query_len.astype(np.int64) * batch.db_len)
    )
    runner = DataParallelRunner(mesh=None)
    dev_args, plan, B, has_n = runner._stream_args(batch)
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]

    t_walk = _best(
        lambda: runner.fill_walk_from_stream_args(
            dev_args, plan, B, has_n, s1, s2
        ), args.reps,
    )
    t_score = _best(
        lambda: runner.scores_from_stream_args(dev_args, plan, B, has_n),
        args.reps,
    )
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "streamed Gotoh fast4 fill+walk GCUPS",
        "value": cells / t_walk / 1e9,
        "fill_walk_s": t_walk,
        "score_fill_s": t_score,
        "score_gcups": cells / t_score / 1e9,
        "pairs": args.pairs, "length": args.length,
        "np_slots": plan.np_slots, "rows": plan.n_rows,
        "engine": runner.engine(plan), "card": card,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
