"""Weighted-A* aligner.

Reference: align (src/align.rs:19-57).  The search itself is inherently
sequential heap-driven host work (kept bit-exact in ops.oracle_astar,
including Rust BinaryHeap pop order); the batched device equivalent is
models.banded.BandedAligner (fixed corridor instead of a heap frontier).

The reference's main always calls align() with local=false regardless of
--mode (src/main.rs:64); compat mode reproduces that.  With compat=False,
Mode.SEMI_GLOBAL selects the free-end-gaps expansion (align.rs:59-123)."""

from __future__ import annotations

import os
from typing import List, Tuple

from sequencealigning_tpu.config import Mode
from sequencealigning_tpu.errors import AlignerError, AlignmentError
from sequencealigning_tpu.models.base import Aligner
from sequencealigning_tpu.ops.oracle_astar import astar_align


class AStarAligner(Aligner):
    def _astar_one(self, s1: bytes, s2: bytes, semi: bool):
        """Native C search when available (bit-identical heap order,
        fuzz-pinned in tests/test_native.py; ~2 orders of magnitude the
        Python oracle's speed), Python oracle otherwise."""
        sch = self.config.scoring
        if not os.environ.get("SEQALIGN_NO_NATIVE"):
            try:
                from sequencealigning_tpu import native

                r = native.astar_align_native(
                    s1, s2, sch.match_, sch.mismatch, sch.gap_open,
                    sch.gap_extend, sch.epsilon, semi_global=semi,
                )
                if r is not None:
                    return r
            except AlignmentError:
                raise  # search-semantics failure, same as the oracle's
            except Exception:
                pass  # library/load anomaly: fall back
        return astar_align(s1, s2, scheme=sch, semi_global=semi)

    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.compat:
            semi = False  # main.rs:64 hardcodes local=false
        else:
            semi = self.config.mode is Mode.SEMI_GLOBAL
        results = self._batch_native(pairs, semi)
        out = []
        for b, (s1, s2) in enumerate(pairs):
            r = results[b] if results is not None else None
            try:
                if isinstance(r, str):
                    raise AlignmentError(r)
                if r is None:
                    r = self._astar_one(s1, s2, semi)
                score, a1, a2 = r
                out.append(dict(score=score, aligned_query=a1, aligned_db=a2))
            except AlignerError as e:
                out.append(e)
        return out

    def _batch_native(self, pairs, semi: bool):
        """Threaded native batch (the pair loop is embarrassingly
        parallel, per-pair isolation like src/main.rs:61-78); None =
        library missing, per-pair None = allocation anomaly (falls back
        pair-wise), per-pair str = the oracle's AlignmentError message."""
        if os.environ.get("SEQALIGN_NO_NATIVE") or len(pairs) < 2:
            return None
        try:
            from sequencealigning_tpu import native

            sch = self.config.scoring
            return native.astar_align_batch_native(
                [p[0] for p in pairs], [p[1] for p in pairs],
                sch.match_, sch.mismatch, sch.gap_open, sch.gap_extend,
                sch.epsilon, semi_global=semi,
            )
        except Exception:
            return None
