"""Randomized cross-engine differential soak.

Runs rounds of randomized (lengths, scheme, compat, engine) checks against
the scalar oracles on a GPU, soaking the CUDA fills and every fill XLA
compiles for the card (the pytest suite runs the same logic on the CPU's
lax engine).  Needs a GPU; exits non-zero without one.

    python benchmarks/soak.py --rounds 8 --seed 1

Each round draws a fresh batch and checks:
  * streamed Gotoh fill (+ fast4 walk) vs oracle_gotoh
  * banded fill, band wide enough to cover the optimum, full + fast4 dirs
  * tiled long-pair fill vs oracle
  * row-folded small-batch fill (fold factor cycling 8/4/2) vs oracle
  * textbook WFA penalty vs the penalty-converted Gotoh score
Exit code 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from _gpu import require_gpu


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-len", type=int, default=600)
    args = ap.parse_args()

    print(require_gpu("soak"), file=sys.stderr)

    from sequencealigning_tpu.config import ScoringScheme, WfaPenalties
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops import oracle_gotoh
    from sequencealigning_tpu.ops.nw_affine_stream import nw_affine_stream_batch
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_batch,
        nw_affine_tiled_fold_batch,
    )
    from sequencealigning_tpu.ops.nw_affine_modes import (
        modes_end_cell,
        nw_affine_modes_batch,
    )
    from sequencealigning_tpu.ops.nw_affine_stream_modes import (
        nw_affine_stream_modes_batch,
        stream_modes_best,
    )
    from sequencealigning_tpu.ops.nw_banded import nw_banded_batch
    from sequencealigning_tpu.ops.traceback import traceback_stream_batch
    from sequencealigning_tpu.ops.wfa import wfa_textbook_batch

    rng = random.Random(args.seed)
    fails = 0

    def report(engine, rnd, b, got, exp, pair):
        nonlocal fails
        fails += 1
        print(
            f"[soak] MISMATCH {engine} round={rnd} pair={b}: got={got} "
            f"exp={exp} n1={len(pair[0])} n2={len(pair[1])}",
            file=sys.stderr,
        )

    for rnd in range(args.rounds):
        compat = rng.random() < 0.5
        sch = ScoringScheme() if rnd % 2 == 0 else ScoringScheme(
            match_=rng.randint(1, 9),
            mismatch=-rng.randint(1, 12),
            gap_open=-rng.randint(0, 14),
            gap_extend=-rng.randint(1, 8),
        )
        pairs = []
        for _ in range(16):
            n1 = rng.randint(1, args.max_len)
            n2 = rng.randint(1, args.max_len)
            pairs.append(
                (
                    bytes(rng.choice(b"ACGT") for _ in range(n1)),
                    bytes(rng.choice(b"ACGT") for _ in range(n2)),
                )
            )
        batch = pack_batch(pairs, batch_size=16)
        exp = [
            oracle_gotoh.gotoh_score(s1, s2, scheme=sch, compat=compat)
            for s1, s2 in pairs
        ]

        # Streamed fill + fast4 CIGARs.
        res = nw_affine_stream_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            scheme=sch, compat=compat, with_dirs="fast4", np_slots=2,
        )
        for b in range(16):
            got = int(np.asarray(res.finals)[b].max())
            if got != exp[b]:
                report("stream", rnd, b, got, exp[b], pairs[b])
        tbs = traceback_stream_batch(
            np.asarray(res.dirs), np.asarray(res.finals),
            [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
            compat=compat, dirs_mode="fast4",
        )
        for b, r in enumerate(tbs):
            if isinstance(r, Exception):
                report("stream-walk", rnd, b, repr(r), exp[b], pairs[b])
                continue
            score, alns = r
            a1, a2 = alns[0]
            if (
                a1.replace("-", "").encode() != pairs[b][0]
                or a2.replace("-", "").encode() != pairs[b][1]
            ):
                report("stream-walk", rnd, b, "bad-recon", "-", pairs[b])

        # int16 stream state (the lax engine's; the CUDA fill is int32)
        # vs int32 finals, compiled for the card.
        from sequencealigning_tpu.ops.nw_affine_stream import (
            plan_stream as _plan_stream,
            stream_i16_neg,
        )

        _plan = _plan_stream(
            16, batch.query.shape[1], batch.db.shape[1], np_slots=1
        )
        if stream_i16_neg(sch, _plan) is not None:
            import jax.numpy as _jnp

            r16 = nw_affine_stream_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                scheme=sch, compat=compat, with_dirs=False, np_slots=1,
                state_dtype=_jnp.int16, backend="lax",
            )
            for b in range(16):
                got = int(np.asarray(r16.finals)[b].max())
                if got != exp[b]:
                    report("stream-i16", rnd, b, got, exp[b], pairs[b])
        elif rnd == 0:
            print(
                "[soak] i16 leg skipped (scheme range)",
                file=sys.stderr,
            )

        # Streamed textbook modes vs the plain modes engine (end cells).
        mode = "semi" if rnd % 2 == 0 else "local"
        sres = nw_affine_stream_modes_batch(
            batch.query, batch.db, batch.query_len, batch.db_len, mode,
            scheme=sch, np_slots=2, with_dirs=False,
        )
        plain = nw_affine_modes_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            local=(mode == "local"), scheme=sch, with_dirs=False,
        )
        for b in range(16):
            got = stream_modes_best(sres, b)
            expm = modes_end_cell(plain, b)
            if got != expm:
                report(f"stream-modes-{mode}", rnd, b, got, expm, pairs[b])

        # Banded (wide band covers the optimum) in both dirs modes.
        for dm in ("full", "fast4"):
            bres = nw_banded_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                band=args.max_len, scheme=sch, compat=compat, with_dirs=dm,
            )
            for b in range(16):
                got = int(np.asarray(bres.finals)[b].max())
                if got != exp[b]:
                    report(f"banded-{dm}", rnd, b, got, exp[b], pairs[b])

        # Anti-diagonal banded kernel: finals must equal the row kernel's
        # EXACTLY at the same (narrow) band, and the oracle at a wide one;
        # spot-rescore the fast4 walker on two pairs.
        from sequencealigning_tpu.ops.nw_banded_diag import (
            nw_banded_diag_batch,
        )
        from sequencealigning_tpu.ops.traceback import (
            banded_diag_fast4_traceback_pair,
        )

        nb = rng.choice([4, 24])
        brow = nw_banded_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            band=nb, scheme=sch, compat=compat, with_dirs=False,
        )
        bdia = nw_banded_diag_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            band=nb, scheme=sch, compat=compat, with_dirs="fast4",
        )
        if not np.array_equal(
            np.asarray(brow.finals), np.asarray(bdia.finals)
        ):
            report("diag-vs-row", rnd, -1, "finals differ", "-", pairs[0])
        bwide = nw_banded_diag_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            band=args.max_len, scheme=sch, compat=compat, with_dirs=False,
        )
        for b in range(16):
            got = int(np.asarray(bwide.finals)[b].max())
            if got != exp[b]:
                report("diag-wide", rnd, b, got, exp[b], pairs[b])
        ddirs = np.asarray(bdia.dirs)
        for b in (rnd % 16, (rnd + 7) % 16):
            score, alns = banded_diag_fast4_traceback_pair(
                ddirs[:, b, :], np.asarray(bdia.finals)[b],
                pairs[b][0], pairs[b][1], bdia.k_lo_even, compat=compat,
            )
            a1, a2 = alns[0]
            if (
                a1.replace("-", "").encode() != pairs[b][0]
                or a2.replace("-", "").encode() != pairs[b][1]
            ):
                report("diag-walk", rnd, b, "bad-recon", "-", pairs[b])

        # Tiled long-pair engine (multi-tile at this tile width).
        tf = nw_affine_tiled_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            scheme=sch, compat=compat, tile_lanes=128,
        )
        for b in range(16):
            got = int(tf[b].max())
            if got != exp[b]:
                report("tiled", rnd, b, got, exp[b], pairs[b])

        # Row-folded small-batch engine (first nf pairs; nf cycles
        # 1..4 so every fold factor 8 // ceil_pow2(nf) gets soaked).
        nf = 1 + rnd % 4
        ff = nw_affine_tiled_fold_batch(
            batch.query[:nf], batch.db[:nf],
            batch.query_len[:nf], batch.db_len[:nf],
            scheme=sch, compat=compat, tile_lanes=128,
        )
        for b in range(nf):
            got = int(ff[b].max())
            if got != exp[b]:
                report(f"fold{nf}", rnd, b, got, exp[b], pairs[b])

        # Textbook WFA penalty == -(match-0 Gotoh score).  WFA's combined
        # M-wavefront implements the STANDARD affine model while Gotoh's
        # M-only gap opens are stricter (the reference's own two
        # algorithms disagree likewise, see PARITY.md); the models
        # coincide iff mismatch <= 2*gap_extend, so draw penalties there.
        ev = rng.randint(1, 6)
        pen = WfaPenalties(
            mismatch=rng.randint(1, 2 * ev),
            gap_open=rng.randint(0, 6),
            gap_extend=ev,
        )
        eq = ScoringScheme(
            match_=0, mismatch=-pen.mismatch,
            gap_open=-pen.gap_open, gap_extend=-pen.gap_extend,
        )
        # band=max_len = full diagonal coverage (exactness over speed).
        # NOTE: with gcd-1 random schemes this leg runs the score lattice
        # at stride 1 over a ~2*max_len-lane window and can take minutes
        # per round -- slow, not hung.
        wres = wfa_textbook_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            penalties=pen, band=args.max_len,
        )
        for b in range(16):
            if not bool(wres.converged[b]):
                report("wfa-conv", rnd, b, "not converged", "-", pairs[b])
                continue
            got = int(np.asarray(wres.score)[b])
            want = -oracle_gotoh.gotoh_score(
                pairs[b][0], pairs[b][1], scheme=eq, compat=False
            )
            if got != want:
                report("wfa", rnd, b, got, want, pairs[b])

        # Routed WFA model (auto engine: native capped leg + banded
        # escapes): every pair must come back with the exact penalty and
        # a valid alignment.
        from sequencealigning_tpu.config import AlignConfig, Algo
        from sequencealigning_tpu.models.wfa import WfaAligner

        al = WfaAligner(AlignConfig(
            algo=Algo.WFA, compat=False, wfa_penalties=pen,
        ))
        routed = al._align_batch_impl(pairs)
        for b, r in enumerate(routed):
            if not isinstance(r, dict):
                report("wfa-auto", rnd, b, repr(r), "-", pairs[b])
                continue
            want = -oracle_gotoh.gotoh_score(
                pairs[b][0], pairs[b][1], scheme=eq, compat=False
            )
            if r["score"] != want:
                report("wfa-auto", rnd, b, r["score"], want, pairs[b])
            elif r["aligned_query"] is not None and (
                r["aligned_query"].replace("-", "").encode() != pairs[b][0]
                or r["aligned_db"].replace("-", "").encode() != pairs[b][1]
            ):
                report("wfa-auto-walk", rnd, b, "bad-recon", "-", pairs[b])

        # r5 legs: out-of-regime penalties drive the any-state ("std")
        # banded engine + its walkers (incl. the msub walk), pinned to
        # the std scalar oracle; and the on-device WFA offset-log
        # traceback, pinned byte-equal to the host walker.
        pen_oor = WfaPenalties(
            mismatch=2 * pen.gap_extend + rng.randint(1, 4),
            gap_open=pen.gap_open, gap_extend=pen.gap_extend,
        )
        al_oor = WfaAligner(AlignConfig(
            algo=Algo.WFA, compat=False, wfa_penalties=pen_oor,
        ))
        eq_oor = ScoringScheme(
            match_=0, mismatch=-pen_oor.mismatch,
            gap_open=-pen_oor.gap_open, gap_extend=-pen_oor.gap_extend,
        )
        for b, r in enumerate(al_oor._align_batch_impl(pairs)):
            if not isinstance(r, dict):
                report("wfa-std", rnd, b, repr(r), "-", pairs[b])
                continue
            want = -oracle_gotoh.gotoh_score(
                pairs[b][0], pairs[b][1], scheme=eq_oor, compat=False,
                model="std",
            )
            if r["score"] != want:
                report("wfa-std", rnd, b, r["score"], want, pairs[b])

        from sequencealigning_tpu.ops.wfa import (
            wfa_traceback_device,
            wfa_traceback_host,
        )

        dev_alns = wfa_traceback_device(
            wres, [p[0] for p in pairs], [p[1] for p in pairs], pen
        )
        for b in range(16):
            if not bool(wres.converged[b]):
                continue
            _s, h1, h2 = wfa_traceback_host(
                wres, b, pairs[b][0], pairs[b][1], pen
            )
            if dev_alns[b] != (h1, h2):
                report("wfa-dev-tb", rnd, b, dev_alns[b], (h1, h2),
                       pairs[b])

        print(f"[soak] round {rnd} done (compat={compat})", file=sys.stderr)

    print(f"[soak] {'PASS' if fails == 0 else f'{fails} MISMATCHES'}",
          file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
