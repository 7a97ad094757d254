"""WFA aligner.

Reference: wfa_align (src/wfa.rs:23-42), Global mode only (:24-27).

* compat=True: the bit-faithful host emulation (ops.oracle_wfa), score
  reported as len(wavefronts) with the reference's convergence quirks.
* compat=False: the batched device textbook engine (ops.wfa) -- correct
  penalties, static-band pruning, host traceback from the offset log.
  Band escapes re-run with a doubled band (the adaptive behavior of the
  reference's trim, src/wfa.rs:490-623, as retry instead of in-loop
  reallocation); pairs that still escape fall through to the exact
  Gotoh engine under the penalty-converted scheme (match=0), so every
  pair always gets BOTH an exact penalty and an alignment (round 1
  returned a score with no alignment on escape)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sequencealigning_tpu.config import Mode
from sequencealigning_tpu.errors import AlignerError, AlignmentError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.models.base import Aligner
from sequencealigning_tpu.ops import oracle_wfa
from sequencealigning_tpu.ops.wfa import wfa_textbook_batch, wfa_traceback_host


class WfaAligner(Aligner):
    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode in (
            Mode.SEMI_GLOBAL, Mode.LOCAL
        ) and not self.config.compat:
            # Bounded ends-free WFA (WFA2-lib-style spans).  UNBOUNDED
            # ends-free/local is degenerate under min-penalty scoring
            # (the empty alignment costs 0 and always wins), so explicit
            # span bounds are what make these modes well-posed; without
            # them both stay unimplemented like the reference
            # (wfa.rs:24-27).  Span-bounded LOCAL is the same
            # formulation as bounded ends-free -- free skips up to
            # (lead1, lead2, trail1, trail2) on BOTH sequences at BOTH
            # ends -- so the two modes share the spans engine; the
            # PARITY.md modes matrix records the degeneracy argument as
            # the permanent decision for the unbounded cells.
            spans = getattr(self.config, "wfa_spans", None)
            if spans is not None:
                return self._ends_free_batch(pairs, tuple(spans))
        if self.config.mode is not Mode.GLOBAL:
            return [AlignmentError("not implemented") for _ in pairs]
        if self.config.compat:
            return self._compat_batch(pairs)
        return self._textbook_batch(pairs)

    def _ends_free_batch(self, pairs, spans):
        """Textbook semi-global via the wavefront engine's bounded
        ends-free mode (ops.wfa spans): free end skips up to the span
        bounds, assembled as end gaps.  Band-doubling retries like the
        global wavefront route; pairs that never converge report the
        escape."""
        from sequencealigning_tpu.ops.wfa import (
            wfa_ends_free_traceback_host,
        )

        out = [None] * len(pairs)
        pending = list(range(len(pairs)))
        band = self.config.band
        abort_cause = None  # engine-level failure (e.g. length cap)
        while pending and band <= self.wfa_max_band:
            sub = [pairs[i] for i in pending]
            batch = pack_batch(
                sub, batch_size=max(8, -(-len(sub) // 8) * 8)
            )
            try:
                res = wfa_textbook_batch(
                    batch.query, batch.db, batch.query_len, batch.db_len,
                    penalties=self.config.wfa_penalties, band=band,
                    spans=spans,
                )
            except AlignmentError as e:
                # Engine-level abort (e.g. the int16 offset-log length
                # cap): surface the real cause on every pending pair
                # instead of masking it as non-convergence.
                abort_cause = e
                break
            converged = np.asarray(res.converged)
            still = []
            for j, i in enumerate(pending):
                if not converged[j]:
                    still.append(i)
                    continue
                try:
                    score, a1, a2 = wfa_ends_free_traceback_host(
                        res, j, pairs[i][0], pairs[i][1],
                        self.config.wfa_penalties,
                    )
                    out[i] = dict(
                        score=score, aligned_query=a1, aligned_db=a2
                    )
                except AlignerError as e:
                    out[i] = e
            pending = still
            band *= 2
        for i in pending:
            out[i] = (
                AlignmentError(f"ends-free WFA failed: {abort_cause}")
                if abort_cause is not None
                else AlignmentError(
                    "ends-free WFA did not converge within band/s_max"
                )
            )
        return out

    def _compat_batch(self, pairs):
        import os

        use_native = not os.environ.get("SEQALIGN_NO_NATIVE")
        if use_native:
            try:
                from sequencealigning_tpu import native

                use_native = native.available()
            except Exception:
                use_native = False

        out = []
        for s1, s2 in pairs:
            try:
                if use_native:
                    from sequencealigning_tpu import native

                    r = native.wfa_compat_align_native(
                        s1, s2, self.config.wfa_penalties,
                        self.config.wfa_pruning, self.config.wfa_max_steps,
                    )
                    if r is not None:
                        score, a1, a2 = r
                        out.append(
                            dict(score=score, aligned_query=a1, aligned_db=a2)
                        )
                        continue
                score, ocean = oracle_wfa.wfa_align(
                    s1, s2,
                    penalties=self.config.wfa_penalties,
                    pruning=self.config.wfa_pruning,
                    max_steps=self.config.wfa_max_steps,
                )
                a1, a2 = oracle_wfa.wfa_traceback(ocean, s1, s2)
                out.append(dict(score=score, aligned_query=a1, aligned_db=a2))
            except AlignerError as e:
                out.append(e)
        return out

    # Band-doubling cap for escape retries (larger bands square the
    # run-length table's memory; beyond this the Gotoh fallback is both
    # exact and cheaper).
    wfa_max_band = 256
    # Band cap and per-round fast4-dirs device budget for the banded route.
    wfa_banded_max_band = 1024
    wfa_dirs_budget = 1 << 30

    def _textbook_batch(self, pairs):
        """Engine dispatch (config.wfa_engine):

        * "banded" (or "auto" in-regime): min-penalty gap-affine WFA equals
          the negated banded Gotoh fill under the penalty-converted scheme
          (match=0, -x, -o, -e) whenever mismatch <= 2*gap_extend -- in that
          regime adjacent cross-direction gap runs are never optimal, so
          WFA's merged-M affine model and the Gotoh engines' M-only-opens
          model coincide (PARITY.md quirk table).  The banded fill sweeps
          band cells without the wavefront engine's per-lane gathers.
        * "wavefront" (or "auto" out-of-regime): the score-indexed
          wavefront engine (ops.wfa) -- the faithful WFA formalism, exact
          for every scheme.
        """
        engine = getattr(self.config, "wfa_engine", "auto")
        pen = self.config.wfa_penalties
        # In-regime (mismatch <= 2*gap_extend) the reference-model Gotoh
        # kernels coincide with WFA's standard-affine model; out of it
        # the banded route switches to the kernel's any-state-open
        # variant (ops.nw_banded_diag model="std"), which matches WFA's
        # merged M-wavefront for EVERY penalty scheme.
        in_regime = pen.mismatch <= 2 * pen.gap_extend
        model = "ref" if in_regime else "std"
        if engine == "banded":
            return self._banded_route(pairs, model=model)
        if engine == "wavefront":
            return self._wavefront_batch(pairs)
        if engine == "native":
            out = self._native_raw(pairs)
            if out is None:
                return self._wavefront_batch(pairs)
            return self._fill_rest(pairs, out, self._wavefront_batch)
        # auto: WFA is output-sensitive (work ~ penalty * span), so low-
        # divergence pairs go to the scalar host engine (one L1-resident
        # compare per live diagonal, no per-lane device gather).
        # High-divergence pairs hit WFA's O(penalty^2) wall and go to the
        # banded Gotoh fill, whose cost is divergence-independent.  Route:
        # native capped at wfa_native_s_cap penalty units (~10% of a
        # divergent pair's full work), escapees to the banded route (in
        # its model-matched variant, so every scheme gets the device path).
        # This routing was tuned on another accelerator; its GPU numbers
        # are not measured (ROADMAP S6).
        out = self._native_raw(pairs, s_max=self.wfa_native_s_cap)
        if out is None:
            return self._banded_route(pairs, model=model)
        return self._fill_rest(
            pairs, out,
            lambda rest: self._banded_route(rest, model=model),
        )

    # Penalty cap for the native leg of the auto route (divergence gate:
    # pairs needing more than this go to the divergence-independent banded
    # kernel instead of paying WFA's O(penalty^2) on the host).  Tuned to
    # the cost-crossover: the vectorized native fill measures
    # ~0.8 ns * s^2 per pair single-core (10 kb pairs, 4/2/6 penalties;
    # 0.22/1.10/3.25/8.39 ms at s = 400/1200/2000/3200), matching the
    # banded route's ~1.09 ms/pair (919 pairs/s, config 3) at s ~ 1150 --
    # so below this cap the host leg is the cheaper engine, and an
    # escapee's wasted capped work (~0.86 ms) stays under one banded fill.
    wfa_native_s_cap = 1024

    @staticmethod
    def _fill_rest(pairs, out, engine_fn):
        rest = [i for i, r in enumerate(out) if r is None]
        if rest:
            for i, r in zip(rest, engine_fn([pairs[i] for i in rest])):
                out[i] = r
        return out

    def _native_raw(self, pairs, s_max=None):
        """Exact threaded host engine (native.wfa_textbook_align_batch):
        full-precision WFA for ANY scheme, no band.  Returns None if the
        library is unavailable; per-pair None where the engine declined
        (penalty cap / memory budget) -- callers route those onward."""
        import os

        if os.environ.get("SEQALIGN_NO_NATIVE"):
            return None
        try:
            from sequencealigning_tpu import native

            if not native.available():
                return None
            kw = {} if s_max is None else dict(s_max=s_max)
            res = native.wfa_textbook_align_batch_native(
                pairs, self.config.wfa_penalties, **kw
            )
        except Exception:
            return None
        if res is None:
            return None
        return [
            None if r is None
            else dict(score=r[0], aligned_query=r[1], aligned_db=r[2])
            for r in res
        ]

    def _banded_route(self, pairs, model: str = "ref"):
        """Banded-Gotoh textbook engine with a band certificate: a pair is
        accepted only when two band widths agree on its score -- strictly
        stronger than the wavefront engine's converged-in-band acceptance.
        Fills run on the anti-diagonal kernel (ops.nw_banded_diag, ~1.6x
        the row sweep); because its lane count rounds up to 128-lane
        blocks, the certificate fill requests band+128 -- +256 diagonals,
        which grows the lane count by EXACTLY one block
        (round_up(x+128, 128) == round_up(x, 128) + 128), so the two
        fills always genuinely differ at minimal extra cost.  Disagreeing
        pairs escalate past both widths; past the cap the exact
        full-width fallback takes over (always an alignment).

        model="std" runs the kernel's any-state-open variant -- exact
        standard-affine WFA for schemes OUTSIDE the coincidence regime
        (mismatch > 2*gap_extend, PARITY.md), where the M-only Gotoh
        engines would under-count adjacent cross-direction gap runs.  Its
        past-the-cap fallback is one full-width std fill (every diagonal
        in band; no certificate needed) instead of the Gotoh engine."""
        from sequencealigning_tpu.config import ScoringScheme
        from sequencealigning_tpu.ops.nw_banded_diag import (
            nw_banded_diag_batch,
        )
        from sequencealigning_tpu.ops.traceback import (
            banded_diag_fast4_traceback_pair,
        )

        pen = self.config.wfa_penalties
        eq = ScoringScheme(
            match_=0, mismatch=-pen.mismatch,
            gap_open=-pen.gap_open, gap_extend=-pen.gap_extend,
        )
        n = len(pairs)
        out = [None] * n
        pending = []
        for i, (s1, s2) in enumerate(pairs):
            if len(s1) == 0 or len(s2) == 0:
                # Closed form, matching the wavefront engine's I/D chains.
                if len(s1) == 0 and len(s2) == 0:
                    out[i] = dict(score=0, aligned_query="", aligned_db="")
                elif len(s2) == 0:
                    out[i] = dict(
                        score=pen.gap_open + len(s1) * pen.gap_extend,
                        aligned_query=s1.decode("latin-1"),
                        aligned_db="-" * len(s1),
                    )
                else:
                    out[i] = dict(
                        score=pen.gap_open + len(s2) * pen.gap_extend,
                        aligned_query="-" * len(s2),
                        aligned_db=s2.decode("latin-1"),
                    )
            else:
                pending.append(i)
        band = max(8, self.config.band)
        full_round = False
        while pending:
            if band > self.wfa_banded_max_band and not full_round:
                if model != "std":
                    break  # exact Gotoh fallback below
                # std: the Gotoh fallback is the wrong model out of
                # regime -- run ONE full-width round instead (the band
                # covers every diagonal of every pending pair, so the
                # fill is the complete DP matrix and cannot escape).
                full_round = True
                band = max(
                    max(len(pairs[i][0]), len(pairs[i][1]))
                    for i in pending
                )
            still = []
            for chunk in self._dirs_chunked(pairs, pending, band):
                sub = [pairs[i] for i in chunk]
                batch = pack_batch(
                    sub, batch_size=max(8, -(-len(sub) // 8) * 8)
                )
                res = nw_banded_diag_batch(
                    batch.query, batch.db, batch.query_len, batch.db_len,
                    band=band, scheme=eq, compat=False, with_dirs="fast4",
                    model=model,
                )
                f1 = np.asarray(res.finals)
                if full_round:
                    certified = list(enumerate(chunk))
                else:
                    chk = nw_banded_diag_batch(
                        batch.query, batch.db, batch.query_len,
                        batch.db_len,
                        band=band + 128, scheme=eq, compat=False,
                        with_dirs=False, model=model,
                    )
                    f2 = np.asarray(chk.finals)
                    certified = [
                        (j, i)
                        for j, i in enumerate(chunk)
                        if int(f1[j].max()) == int(f2[j].max())
                    ]
                    still.extend(
                        i
                        for j, i in enumerate(chunk)
                        if int(f1[j].max()) != int(f2[j].max())
                    )
                if not certified:
                    continue
                from sequencealigning_tpu.ops.traceback_device import (
                    banded_diag_device_tbs,
                    use_device_walk,
                )

                if use_device_walk(self.config):
                    # Device walk of the certified slots (2-bit op fetch
                    # instead of the band dirs tensor).
                    tbs = banded_diag_device_tbs(
                        res.dirs, f1,
                        [pairs[i][0] for _j, i in certified],
                        [pairs[i][1] for _j, i in certified],
                        res.k_lo_even, compat=False,
                        pair_idx=np.asarray(
                            [j for j, _i in certified], np.int32
                        ),
                        std=model == "std",
                    )
                else:
                    dirs = np.asarray(res.dirs)  # one fetch per chunk
                    tbs = []
                    for j, i in certified:
                        try:
                            tbs.append(
                                banded_diag_fast4_traceback_pair(
                                    dirs[:, j, :], f1[j],
                                    pairs[i][0], pairs[i][1],
                                    res.k_lo_even, compat=False,
                                    std=model == "std",
                                )
                            )
                        except AlignerError as e:
                            tbs.append(e)
                for (_j, i), r in zip(certified, tbs):
                    if isinstance(r, AlignerError):
                        out[i] = r
                        continue
                    score, alns = r
                    out[i] = dict(
                        score=-score,
                        aligned_query=alns[0][0],
                        aligned_db=alns[0][1],
                    )
            pending = still
            # Escalate past both this round's fill AND its certificate
            # width (the +128 keeps the next lane count strictly larger).
            band = 2 * band + 128
        if pending:
            self._gotoh_fallback(pairs, pending, out)
        return out

    def _dirs_chunked(self, pairs, pending, band):
        """Split `pending` so each chunk's fast4 dirs tensor stays under
        the device budget.  The diag layout stores one 4-bit code per
        wavefront per lane: ~((l1+l2)/16) u32 words x L lanes per pair."""
        l1 = max(len(pairs[i][0]) for i in pending)
        l2 = max(len(pairs[i][1]) for i in pending)
        diffs = [len(pairs[i][0]) - len(pairs[i][1]) for i in pending]
        span = max(0, max(diffs)) - min(0, min(diffs)) + 2 * band + 2
        l_est = -(-(span // 2) // 128) * 128
        per_pair = max(1, ((l1 + l2) // 16 + 1) * 4 * l_est)
        max_pairs = max(8, int(self.wfa_dirs_budget // per_pair) // 8 * 8)
        return [
            pending[lo : lo + max_pairs]
            for lo in range(0, len(pending), max_pairs)
        ]

    def _wavefront_batch(self, pairs):
        out = [None] * len(pairs)
        pending = list(range(len(pairs)))
        band = self.config.band
        while pending and band <= self.wfa_max_band:
            sub = [pairs[i] for i in pending]
            batch = pack_batch(
                sub, batch_size=max(8, -(-len(sub) // 8) * 8)
            )
            try:
                res = wfa_textbook_batch(
                    batch.query, batch.db, batch.query_len, batch.db_len,
                    penalties=self.config.wfa_penalties, band=band,
                )
            except AlignmentError:
                break  # beyond the int16 offset cap: exact fallback below
            converged = np.asarray(res.converged)
            # Batched device traceback first (the offset log never leaves
            # the device; the walk scan emits 3 bytes/step of RLE ops vs
            # fetching the whole (S, 3, B, K) history): routed exactly
            # like the Gotoh fast4 walks.  Pairs whose device walk fails
            # validation (or on the host route) fall back per pair.
            from sequencealigning_tpu.ops.traceback_device import (
                use_device_walk,
            )

            dev_alns = None
            if use_device_walk(self.config):
                from sequencealigning_tpu.ops.wfa import (
                    wfa_traceback_device,
                )

                dev_alns = wfa_traceback_device(
                    res, [pairs[i][0] for i in pending],
                    [pairs[i][1] for i in pending],
                    self.config.wfa_penalties,
                )
            score_h = np.asarray(res.score)
            still = []
            for j, i in enumerate(pending):
                if not converged[j]:
                    still.append(i)
                    continue
                if dev_alns is not None and dev_alns[j] is not None:
                    out[i] = dict(
                        score=int(score_h[j]),
                        aligned_query=dev_alns[j][0],
                        aligned_db=dev_alns[j][1],
                    )
                    continue
                try:
                    score, a1, a2 = wfa_traceback_host(
                        res, j, pairs[i][0], pairs[i][1],
                        self.config.wfa_penalties,
                    )
                    out[i] = dict(
                        score=score, aligned_query=a1, aligned_db=a2
                    )
                except AlignerError as e:
                    out[i] = e
            pending = still
            band *= 2
        if pending:
            self._gotoh_fallback(pairs, pending, out)
        return out

    def _gotoh_fallback(self, pairs, pending, out):
        """Exact escape path: gap-affine min-penalty == negated textbook
        Gotoh under (match=0, -x, -o, -e), so the Gotoh engine provides
        both the exact penalty and an alignment for any pair.

        Model caveat (mirrors the reference's own internal inconsistency,
        PARITY.md): WFA's combined M-wavefront is the standard affine
        model, Gotoh opens gaps from M only; the two coincide whenever
        mismatch <= 2*gap_extend (true for the reference's 4/2/6 defaults
        and any realistic DNA penalties)."""
        import dataclasses

        from sequencealigning_tpu.config import ScoringScheme
        from sequencealigning_tpu.models.gotoh import GotohAligner

        pen = self.config.wfa_penalties
        cfg = dataclasses.replace(
            self.config,
            scoring=ScoringScheme(
                match_=0, mismatch=-pen.mismatch,
                gap_open=-pen.gap_open, gap_extend=-pen.gap_extend,
            ),
            compat=False,
            first_only=True,
        )
        sub = [pairs[i] for i in pending]
        for i, r in zip(pending, GotohAligner(cfg)._align_batch_impl(sub)):
            if isinstance(r, AlignerError):
                out[i] = r
            elif r.get("aligned_query") is None:
                out[i] = dict(
                    score=-r["score"], aligned_query=None, aligned_db=None
                )
            else:
                out[i] = dict(
                    score=-r["score"],
                    aligned_query=r["aligned_query"],
                    aligned_db=r["aligned_db"],
                )
