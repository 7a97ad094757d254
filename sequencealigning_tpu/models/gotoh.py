"""Affine-gap NW (Gotoh) aligner -- the flagship model family.

Reference: n_w_align (src/needleman_wunsch_affine.rs:424-437).  Global mode
runs the streamed batched fill (ops.nw_affine_stream) + co-optimal or
first-path traceback.
In compat mode Local/SemiGlobal raise "not implemented" exactly like the
reference (:433-434); with compat=False they are implemented
(ops.nw_affine_modes): semi-global = free end gaps both sides, local =
Smith-Waterman-affine."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sequencealigning_tpu.config import Mode
from sequencealigning_tpu.errors import AlignerError, AlignmentError
from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
from sequencealigning_tpu.models.base import Aligner
from sequencealigning_tpu.ops.nw_affine_modes import (
    modes_end_cell,
    nw_affine_modes_batch,
)
from sequencealigning_tpu.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch,
    stream_modes_best,
)
from sequencealigning_tpu.ops.nw_affine_stream import (
    MAX_LANES,
    nw_affine_stream_batch,
)
from sequencealigning_tpu.ops.traceback import (
    local_affine_traceback_pair,
    semi_global_traceback_pair,
    traceback_stream_batch,
)


class GotohAligner(Aligner):
    # Widest row the streamed fill lays out (ops.nw_affine_stream.
    # MAX_LANES; on a GPU rows past the CUDA kernel's 4096 lanes run its
    # lax twin, sequencealigning_tpu.backend); beyond it pairs take the
    # tiled-score + verified-banded-alignment path (the reference has no
    # ceiling but its Rc cell grid OOMs far earlier,
    # needleman_wunsch_affine.rs:67-74).
    long_pair_lanes = MAX_LANES
    # Band-doubling cap for the long-pair alignment search.
    long_pair_max_band = 4096

    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode is not Mode.GLOBAL:
            if self.config.compat:
                # Reference parity (needleman_wunsch_affine.rs:433-434).
                return [AlignmentError("not implemented") for _ in pairs]
            return self._modes_batch(pairs)
        batch = trim_for_stream(
            pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        )
        if batch.db.shape[1] + 2 > self.long_pair_lanes:
            return self._long_batch(pairs, batch)
        n_sub = self._dirs_chunks(batch, len(pairs))
        if n_sub > 1 and len(pairs) > 1:
            # Chunked dirs draining: the 1-byte co-optimal dirs tensor
            # outgrows device memory around 4096 x 2kb pairs in one
            # sweep.  Fill-and-drain per sub-batch; each drain frees the
            # previous dirs tensor before the next fill allocates.
            out: List = []
            per = -(-len(pairs) // n_sub)
            for lo in range(0, len(pairs), per):
                out.extend(self._align_batch_impl(pairs[lo : lo + per]))
            return out
        # The streamed-pair fill produces the plain sweep's finals/dirs
        # semantics at ~2x its lane occupancy; pipeline depth bounded by
        # the batch so tiny batches degenerate gracefully to depth 1.
        # Depth 8 is within 2% of the fastest depth measured for the CUDA
        # fill at 4096 x 2 kb (PERF.md): deeper rows leave SMs idle,
        # shallower ones pay the drain slot more often.
        np_slots = max(1, min(8, len(batch.query) // 8))
        first_only = getattr(self.config, "first_only", False)
        if first_only and self._walk_on_device():
            # Production contract: route through the data-parallel
            # runner's FUSED fill+walk dispatch (r5).  One jitted call
            # runs fill and walk (vs fill call + walk call + several
            # small coordinate puts), sequences ship 2-bit wire-packed
            # (4x less H2D), and the batch data-parallelizes over
            # however many chips the mesh holds.  Results are
            # bit-identical to the direct path (same fill, same
            # walker; pinned by the model-layer tests).
            return self._runner_first_only_batch(pairs, batch)
        res = nw_affine_stream_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            scheme=self.config.scoring,
            compat=self.config.compat,
            with_dirs="fast4" if first_only else True,
            np_slots=np_slots,
            state_dtype=getattr(self.config, "stream_state", "i32"),
        )
        if self.config.debug:
            from sequencealigning_tpu.utils.guards import check_finals

            check_finals(
                np.asarray(res.finals)[: len(pairs)],
                batch.query_len[: len(pairs)], batch.db_len[: len(pairs)],
                scheme=self.config.scoring, compat=self.config.compat,
                label="gotoh finals",
            )
        if first_only and self._walk_on_device():
            tb = self._traceback_device(res, pairs)
        else:
            tb = traceback_stream_batch(
                np.asarray(res.dirs), res.finals,
                [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
                compat=self.config.compat,
                dirs_mode="fast4" if first_only else "full",
            )
        out = []
        for r in tb:
            if isinstance(r, AlignerError):
                out.append(r)
                continue
            score, alns = r
            if not alns:
                out.append(AlignmentError("traceback produced no alignment"))
                continue
            out.append(
                dict(
                    score=score,
                    aligned_query=alns[0][0],
                    aligned_db=alns[0][1],
                    alignments=alns,
                )
            )
        return out

    def _dp_runner(self):
        """Lazy per-aligner DataParallelRunner for the fused batch path
        (mesh = every local device; one device on a single chip)."""
        r = getattr(self, "_dp_runner_cache", None)
        if r is None:
            from sequencealigning_tpu.parallel.runner import (
                DataParallelRunner,
            )

            r = DataParallelRunner(
                scheme=self.config.scoring,
                compat=self.config.compat,
                traceback=getattr(self.config, "traceback", "auto"),
                state_dtype=getattr(self.config, "stream_state", "i32"),
            )
            self._dp_runner_cache = r
        return r

    def _runner_first_only_batch(self, pairs, batch):
        """fast4 first-path alignments via the runner's fused fill+walk
        (one dispatch) + per-pair finish/fallback."""
        runner = self._dp_runner()
        args, plan, Bp, has_n = runner._stream_args(batch)
        seqs1 = [p[0] for p in pairs]
        seqs2 = [p[1] for p in pairs]
        finals, handles = runner.fill_walk_from_stream_args(
            args, plan, Bp, has_n, seqs1, seqs2
        )
        finals = np.asarray(finals)
        if self.config.debug:
            from sequencealigning_tpu.utils.guards import check_finals

            check_finals(
                finals[: len(pairs)],
                batch.query_len[: len(pairs)],
                batch.db_len[: len(pairs)],
                scheme=self.config.scoring, compat=self.config.compat,
                label="gotoh finals",
            )
        tb = runner.device_walk_fast4_finish(handles, finals, seqs1, seqs2)
        out = []
        for r in tb:
            if isinstance(r, AlignerError):
                out.append(r)
                continue
            score, alns = r
            out.append(
                dict(
                    score=score,
                    aligned_query=alns[0][0],
                    aligned_db=alns[0][1],
                    alignments=alns,
                )
            )
        return out

    def _walk_on_device(self) -> bool:
        """fast4 traceback routing (config.traceback): walk the dirs
        tensor on device -- fetching 2-bit op codes instead of the whole
        0.5 byte/cell dirs tensor -- when it lives on an accelerator."""
        from sequencealigning_tpu.ops.traceback_device import use_device_walk

        return use_device_walk(self.config)

    def _traceback_device(self, res, pairs):
        """Batched on-device fast4 walk (ops.traceback_device); a pair
        whose walk fails validation (never observed with a healthy fill)
        falls back to fetching its single dirs row and host-walking."""
        from sequencealigning_tpu.ops.traceback import (
            fast4_traceback_pair,
        )
        from sequencealigning_tpu.ops.traceback_device import (
            fast4_stream_align_device,
        )

        alns, scores = fast4_stream_align_device(
            res.dirs, res.finals,
            [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
        )
        out = []
        for b, (s1, s2) in enumerate(pairs):
            if alns[b] is None:
                row, _slot, off = res.plan.pair_coords(b)
                try:
                    out.append(
                        fast4_traceback_pair(
                            np.asarray(res.dirs[:, row, :]), res.finals[b],
                            s1, s2, compat=self.config.compat, d_offset=off,
                        )
                    )
                except AlignmentError as e:
                    out.append(e)
                continue
            out.append((int(scores[b]), [alns[b]]))
        return out

    # Device-memory budget (bytes) for the direction tensor of one
    # streamed fill; beyond it the batch fills in sub-batches drained
    # sequentially.  None: half the device's allocator limit on a GPU
    # (device.memory_stats()["bytes_limit"]), 9 GiB on the CPU.
    dirs_hbm_budget = None

    def _dirs_budget(self) -> int:
        if self.dirs_hbm_budget is not None:
            return self.dirs_hbm_budget
        import jax

        dev = jax.devices()[0]
        if dev.platform == "cpu":
            return 9 * 2 ** 30
        return dev.memory_stats()["bytes_limit"] // 2

    def _dirs_chunks(self, batch, n_pairs: int, per_byte=None,
                     engine=None) -> int:
        """Number of fill-and-drain sub-batches needed to keep the dirs
        tensor under budget.  Per pair the streamed layout stores ~s * P
        bytes (1 byte/cell full mode, 1/2 byte fast4; the textbook-modes
        layouts are always full-byte, per_byte=1).  The lax twin also
        holds the unpacked byte per cell until it packs the words; engine
        None is the streamed global fill's engine for this width."""
        from sequencealigning_tpu import backend
        from sequencealigning_tpu.io.encode import round_up

        l1 = batch.query.shape[1]
        l2 = batch.db.shape[1]
        s = round_up(max(l1, l2) + 1, 128)
        p = round_up(l2 + 2, 128)
        if per_byte is None:
            per_byte = (
                1.0
                if not getattr(self.config, "first_only", False)
                else 0.5
            )
        if (engine or backend.engine("stream", "auto", p)) == "lax":
            per_byte += 1.0
        total = n_pairs * s * p * per_byte
        return max(1, int(-(-total // self._dirs_budget())))

    def _long_batch(self, pairs: List[Tuple[bytes, bytes]], batch):
        """Long-pair path (db beyond the streamed fill's MAX_LANES):

        1. exact corner finals via the tiled fill (ops.nw_affine_tiled,
           score-only, any length);
        2. alignment via a banded fast4 fill with band doubling until the
           banded score MATCHES the exact score -- at that point the banded
           path is provably optimal (Ukkonen-style verification).

        3. if the optimum still escapes the capped band, the Myers-Miller
           divide-and-conquer alignment (ops.mm_align: exact, O(n) memory,
           any length) -- in compat mode its textbook-optimal alignment is
           positionally rescored and kept only if it reaches the exact
           compat score (the boundary quirk does not decompose over cuts);
           the rare remainder returns the exact score with the alignment
           explicitly absent.
        """
        from sequencealigning_tpu.ops.nw_affine_tiled import (
            nw_affine_tiled_batch,
            nw_affine_tiled_fold_batch,
            nw_affine_tiled_single,
        )
        from sequencealigning_tpu.ops.nw_banded_diag import (
            nw_banded_diag_batch,
        )
        from sequencealigning_tpu.ops.traceback import (
            banded_diag_fast4_traceback_pair,
        )

        nb = len(pairs)
        cells = [max(1, len(a) * len(b)) for a, b in pairs]
        groups = {1: 1, 2: 2, 3: 4, 4: 4}.get(nb, 8)
        if nb <= 4 and sum(cells) >= 0.7 * groups * max(cells):
            # Few similar-length long pairs: ONE folded dispatch runs all
            # of them on all 8 rows (fold = 8 // ceil_pow2(B));
            # the fill pads every pair to the longest, so mixed sizes
            # (sum(cells) << G * max) fall through to serial folds below.
            exact = nw_affine_tiled_fold_batch(
                batch.query[:nb], batch.db[:nb],
                batch.query_len[:nb], batch.db_len[:nb],
                scheme=self.config.scoring, compat=self.config.compat,
            )
        elif nb < 6:
            # The row-folded fill runs each pair on all 8 rows; serial
            # folded calls beat the batched sweep until ~6 pairs fill
            # the rows anyway.
            exact = np.stack(
                [
                    nw_affine_tiled_single(
                        s1, s2,
                        scheme=self.config.scoring,
                        compat=self.config.compat,
                    )
                    for s1, s2 in pairs
                ]
            )
        else:
            exact = nw_affine_tiled_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                scheme=self.config.scoring, compat=self.config.compat,
            )
        n = len(pairs)
        scores = exact[:n].max(axis=1)
        out: List = [None] * n
        pending = list(range(n))
        band = max(self.config.band, 128)
        while pending and band <= self.long_pair_max_band:
            res = nw_banded_diag_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                band=band, scheme=self.config.scoring,
                compat=self.config.compat, with_dirs="fast4",
            )
            bf = np.asarray(res.finals)[:n]
            resolved = [
                b for b in pending if int(bf[b].max()) == int(scores[b])
            ]
            still = [
                b for b in pending if int(bf[b].max()) != int(scores[b])
            ]
            if resolved and self._walk_on_device():
                # Device walk of just the resolved slots: fetches 2-bit
                # op codes instead of the whole band dirs tensor.
                from sequencealigning_tpu.ops.traceback_device import (
                    banded_diag_device_tbs,
                )

                tbs = banded_diag_device_tbs(
                    res.dirs, bf,
                    [pairs[b][0] for b in resolved],
                    [pairs[b][1] for b in resolved],
                    res.k_lo_even, compat=self.config.compat,
                    pair_idx=np.asarray(resolved, np.int32),
                )
                for b, r in zip(resolved, tbs):
                    if isinstance(r, AlignerError):
                        out[b] = r
                    else:
                        score, alns = r
                        out[b] = dict(
                            score=score, aligned_query=alns[0][0],
                            aligned_db=alns[0][1], alignments=alns,
                        )
            elif resolved:
                dirs = np.asarray(res.dirs)  # one device fetch per round
                for b in resolved:
                    try:
                        score, alns = banded_diag_fast4_traceback_pair(
                            dirs[:, b, :], bf[b], pairs[b][0], pairs[b][1],
                            res.k_lo_even, compat=self.config.compat,
                        )
                        out[b] = dict(
                            score=score, aligned_query=alns[0][0],
                            aligned_db=alns[0][1], alignments=alns,
                        )
                    except AlignerError as e:
                        out[b] = e
            pending = still
            band *= 2
        for b in pending:
            out[b] = self._mm_fallback(pairs[b], int(scores[b]))
        return out

    def _mm_fallback(self, pair, exact_score: int):
        from sequencealigning_tpu.ops.mm_align import mm_align, mm_score_ops
        from sequencealigning_tpu.ops.traceback import _apply_ops

        s1, s2 = pair
        try:
            ops = mm_align(s1, s2, self.config.scoring)
            got = mm_score_ops(ops, s1, s2, self.config.scoring)
            if self.config.compat and ops and ops[0] in "ID":
                # compat scores the leading gap chain o+(L+1)e: one extra
                # extension (needleman_wunsch_affine.rs:195,207).
                got += self.config.scoring.gap_extend
            if got == exact_score:
                a1, a2 = _apply_ops(ops, s1, s2)
                return dict(
                    score=exact_score, aligned_query=a1, aligned_db=a2
                )
        except AlignerError:
            pass
        # The engine-exact optimum genuinely differs from mm's (compat
        # boundary quirk, or a scheme where the standard affine model's
        # adjacent cross-direction runs beat the reference's M-only-opens
        # model -- see ops.mm_align): exact score, alignment explicitly
        # absent rather than a wrong one.
        return dict(score=exact_score, aligned_query=None, aligned_db=None)

    def _modes_batch(self, pairs: List[Tuple[bytes, bytes]]):
        local = self.config.mode is Mode.LOCAL
        dirs_host: dict = {}  # host route's one-fetch cache (dirs_of)
        batch = pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        # The modes dirs layouts are full-byte: a 4096 x 2 kb batch's dirs
        # tensor alone is ~17 GB.  Fill-and-drain in sub-batches exactly
        # like the global co-optimal path.
        n_sub = self._dirs_chunks(batch, len(pairs), per_byte=1.0,
                                  engine="lax")
        if n_sub > 1 and len(pairs) > 1:
            out: List = []
            per = -(-len(pairs) // n_sub)
            for lo in range(0, len(pairs), per):
                out.extend(self._modes_batch(pairs[lo : lo + per]))
            return out
        # Large batches ride the streamed-pair engine (~2x lane occupancy
        # + batch-scale amortization, ops.nw_affine_stream_modes); small
        # ones keep the plain per-pair kernel (lighter compile/dispatch).
        streamed = len(pairs) >= 32 and batch.query.shape[1] > 0 and (
            batch.db.shape[1] > 0
        )
        if streamed:
            sres = nw_affine_stream_modes_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                "local" if local else "semi", scheme=self.config.scoring,
                state_dtype=getattr(self.config, "stream_state", "i32"),
            )
            coords = [sres.plan.pair_coords(b) for b in range(len(pairs))]
            dirs_dev = sres.dirs
            rowp = np.asarray([c[0] for c in coords], np.int32)
            d_offs = np.asarray([c[2] for c in coords], np.int32)
            t_steps = int(sres.plan.l1 + sres.plan.l2)
            end_xs, end_ys = sres.best_x, sres.best_y

            def end_cell(b):
                return stream_modes_best(sres, b)

            def dirs_of(b):
                # Host route (walked is None): ONE whole-tensor fetch,
                # cached -- np_slots pairs share each row.  Device route:
                # dirs_of only serves rare per-pair fallbacks, so fetch
                # just that pair's row.
                row, _slot, d_off = sres.plan.pair_coords(b)
                if walked is None:
                    if "all" not in dirs_host:
                        dirs_host["all"] = np.asarray(dirs_dev)
                    return dirs_host["all"][:, row, :], d_off
                return np.asarray(dirs_dev[:, row, :]), d_off
        else:
            res = nw_affine_modes_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                local=local, scheme=self.config.scoring,
            )
            dirs_dev = res.dirs
            rowp = np.arange(len(pairs), dtype=np.int32)
            d_offs = np.zeros(len(pairs), np.int32)
            t_steps = int(batch.query.shape[1] + batch.db.shape[1])
            end_xs, end_ys = res.best_x, res.best_y

            def end_cell(b):
                return modes_end_cell(res, b)

            def dirs_of(b):
                if walked is None:
                    if "all" not in dirs_host:
                        dirs_host["all"] = np.asarray(dirs_dev)
                    return dirs_host["all"][:, b, :], 0
                return np.asarray(dirs_dev[:, b, :]), 0

        walked = None
        if self._walk_on_device():
            # On-device batch walk of the full-byte modes layout: only
            # the 2-bit op codes cross the device boundary; failures
            # fall back to the per-pair host walker below.
            from sequencealigning_tpu.ops.traceback_device import (
                modes_walk_device,
            )

            walked = modes_walk_device(
                dirs_dev, end_xs[: len(pairs)], end_ys[: len(pairs)],
                rowp, d_offs,
                [p[0] for p in pairs], [p[1] for p in pairs],
                local, t_steps,
            )

        out = []
        for b, (s1, s2) in enumerate(pairs):
            if not s1 or not s2:
                # Degenerate pair: SW score of an empty sequence is 0, and
                # semi-global end gaps are free -- the masked fill never
                # updates a candidate cell here and would return sentinels.
                if local:
                    out.append(dict(score=0, aligned_query="", aligned_db=""))
                else:
                    out.append(
                        dict(
                            score=0,
                            aligned_query=s1.decode("latin-1")
                            + "-" * len(s2),
                            aligned_db="-" * len(s1) + s2.decode("latin-1"),
                        )
                    )
                continue
            try:
                score, x, y = end_cell(b)
                if walked is not None and walked[b] is not None:
                    mid1, mid2, sx, sy = walked[b]
                    if local:
                        a1, a2 = mid1, mid2
                    else:
                        # Free end gaps around the walked segment
                        # (semi_global_traceback_pair's lead/trail).
                        n1, n2 = len(s1), len(s2)
                        a1 = (
                            s1[:sy].decode("latin-1") + "-" * sx + mid1
                            + s1[y:].decode("latin-1") + "-" * (n2 - x)
                        )
                        a2 = (
                            "-" * sy + s2[:sx].decode("latin-1") + mid2
                            + "-" * (n1 - y) + s2[x:].decode("latin-1")
                        )
                elif local:
                    dirs_b, d_off = dirs_of(b)
                    a1, a2, sy, sx = local_affine_traceback_pair(
                        dirs_b, x, y, s1, s2, d_offset=d_off
                    )
                else:
                    dirs_b, d_off = dirs_of(b)
                    a1, a2 = semi_global_traceback_pair(
                        dirs_b, x, y, s1, s2, d_offset=d_off
                    )
                out.append(dict(score=score, aligned_query=a1, aligned_db=a2))
            except AlignerError as e:
                out.append(e)
        return out
