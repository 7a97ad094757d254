"""Banded affine aligner -- the A*-pruned variant as a fixed-shape masked
band (BASELINE config 4; the batched replacement for the reference's
heap-based weighted-A* pruning)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sequencealigning_tpu.config import Mode
from sequencealigning_tpu.errors import AlignerError, AlignmentError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.models.base import Aligner


class BandedAligner(Aligner):
    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode is not Mode.GLOBAL:
            return [AlignmentError("not implemented") for _ in pairs]
        # first_only: 4-bit fast4 dirs (half the dirs traffic, priority
        # first-path walk) -- mirrors the GotohAligner knob; the default
        # keeps the full 7-bit layout whose walk order matches the
        # co-optimal enumeration tests.
        fast4 = getattr(self.config, "first_only", False)
        batch = pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        if fast4:
            # First-path contract: the anti-diagonal kernel (no in-row
            # prefix-max scan, parity-packed lanes) is ~1.6x the row sweep
            # at config-4 shape (PERF.md round 2 cont.).
            from sequencealigning_tpu.ops.nw_banded_diag import (
                nw_banded_diag_batch,
            )
            from sequencealigning_tpu.ops.traceback import (
                banded_diag_fast4_traceback_batch,
            )

            res = nw_banded_diag_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                band=self.config.band,
                scheme=self.config.scoring,
                compat=self.config.compat,
                wildcard=True,  # N matches anything (align.rs:298-304)
                with_dirs="fast4",
            )
            from sequencealigning_tpu.ops.traceback_device import (
                banded_diag_device_tbs,
                use_device_walk,
            )

            finals = np.asarray(res.finals)
            s1s = [p[0] for p in pairs]
            s2s = [p[1] for p in pairs]
            if use_device_walk(self.config):
                # Walk on device: fetch 2-bit op codes, not the dirs
                # tensor (tests pin equality with the host walker).
                tbs = banded_diag_device_tbs(
                    res.dirs, finals, s1s, s2s, res.k_lo_even,
                    compat=self.config.compat,
                )
            else:
                tbs = banded_diag_fast4_traceback_batch(
                    np.asarray(res.dirs), finals, s1s, s2s,
                    res.k_lo_even, compat=self.config.compat,
                )
            out = []
            for r in tbs:
                if isinstance(r, AlignerError):
                    out.append(r)
                    continue
                score, alns = r
                out.append(
                    dict(
                        score=score,
                        aligned_query=alns[0][0],
                        aligned_db=alns[0][1],
                    )
                )
            return out
        # Full 7-bit co-optimal layout on the diag kernel (same bytes as
        # the row layout cell-for-cell, so the enumeration is identical).
        from sequencealigning_tpu.ops.nw_banded_diag import (
            nw_banded_diag_batch,
        )
        from sequencealigning_tpu.ops.traceback import (
            banded_diag_traceback_pair,
        )

        res = nw_banded_diag_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            band=self.config.band,
            scheme=self.config.scoring,
            compat=self.config.compat,
            wildcard=True,
            with_dirs="full",
        )
        dirs = np.asarray(res.dirs)
        finals = np.asarray(res.finals)
        out = []
        for b, (s1, s2) in enumerate(pairs):
            try:
                score, alns = banded_diag_traceback_pair(
                    dirs[:, b, :], finals[b], s1, s2, res.k_lo_even,
                    compat=self.config.compat, max_alignments=1,
                )
                if not alns:
                    raise AlignmentError("banded traceback found no alignment")
                out.append(
                    dict(
                        score=score,
                        aligned_query=alns[0][0],
                        aligned_db=alns[0][1],
                    )
                )
            except AlignerError as e:
                out.append(e)
        return out
