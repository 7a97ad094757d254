"""On-hardware certification of the device traceback walkers.

Runs randomized batches on a GPU and compares EVERY pair's
device-walked alignment byte-for-byte against the host walker reading
the fetched dirs tensor -- across the stream fast4 layout and the
banded-diag layout, with SNP-only, indel-heavy, and random-pair
mutation profiles (indels make walks longer than max(n1, n2), crossing
the early-exit chunk boundaries; random pairs stress gap runs).

Usage: python benchmarks/walk_verify.py [--rounds 3] [--pairs 64]
Exit 0 = every comparison identical.  Needs a GPU; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from _gpu import require_gpu


def _mutate(rng, ref: bytes, n_sub: int, n_indel: int) -> bytes:
    mut = bytearray(ref)
    for _ in range(n_sub):
        p = int(rng.integers(0, len(mut)))
        mut[p] = int(rng.choice([c for c in b"ACGT" if c != mut[p]]))
    for _ in range(n_indel):
        p = int(rng.integers(0, len(mut)))
        ln = int(rng.integers(1, 12))
        if rng.random() < 0.5 and len(mut) > ln + 1:
            del mut[p : p + ln]
        else:
            ins = rng.choice(list(b"ACGT"), ln).astype(np.uint8).tobytes()
            mut[p:p] = ins
    return bytes(mut)


def _make_pairs(rng, n, length, profile):
    pairs = []
    for _ in range(n):
        ref = rng.choice(list(b"ACGT"), length).astype(np.uint8).tobytes()
        if profile == "snp":
            mut = _mutate(rng, ref, length // 100, 0)
        elif profile == "indel":
            mut = _mutate(rng, ref, length // 200, max(2, length // 300))
        else:  # random: unrelated sequences (all-gap-ish walks)
            mut = rng.choice(
                list(b"ACGT"), int(rng.integers(length // 2, length))
            ).astype(np.uint8).tobytes()
        pairs.append((mut, ref))
    return pairs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--length", type=int, default=1022)
    args = ap.parse_args()

    print(require_gpu("walk_verify"), file=sys.stderr)
    import jax

    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu.ops.nw_affine_stream import (
        nw_affine_stream_batch,
    )
    from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch
    from sequencealigning_tpu.ops.traceback import (
        banded_diag_fast4_traceback_pair,
        fast4_traceback_pair,
    )
    from sequencealigning_tpu.ops.traceback_device import (
        banded_diag_align_device,
        fast4_stream_align_device,
    )

    rng = np.random.default_rng(17)
    failures = 0
    checked = 0
    for rnd in range(args.rounds):
        for profile in ("snp", "indel", "random"):
            pairs = _make_pairs(rng, args.pairs, args.length, profile)
            s1s = [p[0] for p in pairs]
            s2s = [p[1] for p in pairs]

            # --- stream fast4 layout ---
            batch = trim_for_stream(pack_batch(pairs, batch_size=len(pairs)))
            res = nw_affine_stream_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                with_dirs="fast4",
            )
            alns, scores = fast4_stream_align_device(
                res.dirs, res.finals, s1s, s2s, res.plan
            )
            dirs_host = np.asarray(res.dirs)
            for b in range(len(pairs)):
                row, _slot, off = res.plan.pair_coords(b)
                want_score, want = fast4_traceback_pair(
                    dirs_host[:, row, :], res.finals[b], s1s[b], s2s[b],
                    d_offset=off,
                )
                checked += 1
                if (
                    alns[b] is None
                    or int(scores[b]) != want_score
                    or alns[b] != want[0]
                ):
                    failures += 1
                    print(
                        f"[walk-verify] STREAM MISMATCH r{rnd} {profile} "
                        f"pair {b}", file=sys.stderr,
                    )

            # --- banded-diag layout (band wide enough for the profile) ---
            band = 64 if profile != "random" else 256
            bb = pack_batch(pairs, batch_size=len(pairs))
            bres = nw_banded_diag_batch(
                bb.query, bb.db, bb.query_len, bb.db_len, band=band,
                with_dirs="fast4",
            )
            bfin = np.asarray(bres.finals)
            balns, bscores = banded_diag_align_device(
                bres.dirs, bfin, s1s, s2s, bres.k_lo_even
            )
            bdirs = np.asarray(bres.dirs)
            for b in range(len(pairs)):
                want_score, want = banded_diag_fast4_traceback_pair(
                    bdirs[:, b, :], bfin[b], s1s[b], s2s[b],
                    bres.k_lo_even,
                )
                checked += 1
                got = (
                    (int(bscores[b]), balns[b])
                    if balns[b] is not None
                    else None
                )
                if got != (want_score, want[0]):
                    failures += 1
                    print(
                        f"[walk-verify] BANDED MISMATCH r{rnd} {profile} "
                        f"pair {b}", file=sys.stderr,
                    )
            print(
                f"[walk-verify] round {rnd} {profile}: ok "
                f"(cumulative {checked} comparisons)", file=sys.stderr,
            )

    print(
        f'{{"checked": {checked}, "failures": {failures}, '
        f'"backend": "{jax.default_backend()}"}}'
    )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
