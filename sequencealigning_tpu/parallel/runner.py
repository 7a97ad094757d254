"""Data-parallel batch runner: pairs sharded over the mesh's data axis.

Each device fills an independent slab of the batch with the Gotoh kernel
(ops.nw_affine) under shard_map; scores come back either sharded (left on
device for the next pipeline stage) or gathered to every host via an XLA
all_gather over the interconnect -- the merge pattern of BASELINE config 5.

Per-pair failure isolation is structural: invalid rows (PairBatch.valid
False) are padding that aligns to score 0 and is dropped on the host, so a
bad pair can never poison its neighbors (the batch-level analog of the
reference driver's per-pair error handling, src/main.rs:68-76).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from sequencealigning_tpu import backend as _backend
from sequencealigning_tpu.config import ScoringScheme
from sequencealigning_tpu.io.encode import PairBatch, round_up, trim_for_stream
from sequencealigning_tpu.ops.nw_affine import _gotoh_fill_lax
from sequencealigning_tpu.ops.nw_affine_modes import modes_reduce
from sequencealigning_tpu.ops.nw_affine_stream import (
    capture_params,
    gotoh_fill_stream_cuda,
    gotoh_fill_stream_lax,
    plan_stream,
    resolve_stream_state,
)
from sequencealigning_tpu.ops.nw_affine_stream_modes import (
    gotoh_fill_stream_modes_lax,
)
from sequencealigning_tpu.parallel.mesh import make_mesh


def _unpack_wire(p2, nm, lens, L, has_n: bool):
    """Device-side unpack of the 2-bit wire format (io.encode.wire_pack_codes):
    (R_loc, NP, ceil(L/4)) uint8 packed bases [+ (R_loc, NP, ceil(L/8))
    uint8 N bitmask] + (R_loc, NP) int32 true lengths -> (R_loc, NP, L)
    int32 one-hot nibble codes, bit-identical to the unpacked host layout
    (PAD=0 beyond each slot's true length, N=15 where the mask is set).
    Pure elementwise work XLA fuses into the fill's input build; it cuts
    host->device sequence bytes 4x."""
    p = p2.astype(jnp.int32)
    k = jnp.stack([(p >> (2 * i)) & 3 for i in range(4)], axis=-1)
    codes = (jnp.int32(1) << k).reshape(p2.shape[:-1] + (p2.shape[-1] * 4,))
    codes = codes[..., :L]
    if has_n:
        nb = nm.astype(jnp.int32)
        bits = jnp.stack([(nb >> i) & 1 for i in range(8)], axis=-1)
        nbit = bits.reshape(nm.shape[:-1] + (nm.shape[-1] * 8,))[..., :L]
        codes = jnp.where(nbit != 0, 15, codes)
    pos = jax.lax.broadcasted_iota(jnp.int32, codes.shape, codes.ndim - 1)
    return jnp.where(pos < lens[..., None], codes, 0)


def _mk_streams(q_r, d_r, plan):
    """Per-row code streams from the compact (R_loc, NP, L) int8 batch,
    built on device (host->device traffic = 1 byte/char)."""
    S, T = plan.s, plan.t_total

    def one(a):
        r, np_, l = a.shape
        s_ = jnp.pad(a.astype(jnp.int32), ((0, 0), (0, 0), (1, S - l - 1)))
        s_ = s_.reshape(r, np_ * S)
        return jnp.pad(s_, ((0, 0), (0, T - np_ * S)))

    return one(q_r), one(d_r)


class DataParallelRunner:
    """Shards batches of pairs over mesh axis 'data' and runs the fill.

    backend: 'auto' (the platform's engine for each batch's row width,
    sequencealigning_tpu.backend), 'lax' or 'cuda' -- the streamed
    global fill's engine; every other fill here runs its lax twin.

    np_slots: pairs pipelined per stream row (ops.nw_affine_stream); the
    row count is the batch over np_slots, and each row is one CUDA block.
    8 is within 2% of the fastest depth measured at 4096 x 2 kb on an
    H100 (PERF.md); 32 left 128 rows for the card's 132 SMs.
    """

    def __init__(
        self,
        mesh: Optional[Mesh] = None,
        scheme: ScoringScheme = ScoringScheme(),
        compat: bool = True,
        wildcard: bool = False,
        backend: str = "auto",
        gather: bool = True,
        kernel: str = "stream",
        np_slots: int = 8,
        state_dtype="i32",
        traceback: str = "auto",
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.scheme = scheme
        self.compat = compat
        self.wildcard = wildcard
        _backend.engine("stream", backend)  # validate the request
        self.backend = backend
        self.gather = gather
        if kernel not in ("stream", "plain"):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel
        self.np_slots = np_slots
        # "i32" | "i16" | "auto" | dtype, resolved per plan at fn-build
        # time (ops.nw_affine_stream.resolve_stream_state).
        self.state_dtype = state_dtype
        # fast4 traceback routing for the streaming cigars path:
        # "auto" (device walk on an accelerator) / "host" /
        # "device" (ops.traceback_device.use_device_walk).
        self.traceback = traceback
        self._fn_cache = {}
        # Drain instrumentation: bytes fetched device->host by the last
        # device_walk_fast4_finish call, split by path ("rle" | "packed").
        # Benchmarks read these to report the drain's D2H bill.
        self.last_drain_bytes = 0
        self.last_drain_path = ""

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh.devices.shape))

    def _sharded_fn(self, l1: int, l2: int, p: int):
        key = (l1, l2, p, self.gather)
        if key in self._fn_cache:
            return self._fn_cache[key]
        scheme, compat, wildcard = self.scheme, self.compat, self.wildcard
        gather = self.gather

        def per_shard(seq1, s2v, dsum, n2mask):
            finals, _ = _gotoh_fill_lax(
                seq1, s2v, dsum, n2mask != 0, l1, l2,
                scheme, compat, wildcard, with_dirs=False,
            )
            if gather:
                # Result merge over the interconnect: every host sees
                # every score.
                finals = jax.lax.all_gather(
                    finals, "data", axis=0, tiled=True
                )
            return finals

        spec = P("data")
        out_spec = P() if gather else P("data")
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(spec, spec, spec, spec),
                out_specs=out_spec,
                # all_gather(tiled) output is value-replicated; opt out of
                # the static varying-axes proof for the P() out_spec.
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn

    def engine(self, plan) -> str:
        """The streamed global fill's engine ("cuda" or "lax") for a
        plan's row width."""
        return _backend.engine("stream", self.backend, plan.p)

    def _stream_fill_body(self, plan, dirs_mode, has_n, sdt):
        """Per-shard streamed GLOBAL fill: wire unpack -> fill (CUDA
        kernel, or stream build + lax twin) -> (local finals, dirs).  Shared by _stream_fn and the
        fused fill+walk dispatch so the fill semantics exist in exactly
        one place."""
        scheme, compat, wildcard = self.scheme, self.compat, self.wildcard
        engine = self.engine(plan)

        def body(q2, d2, qn, dn, qll, dll, dsums, n2s):
            q_r = _unpack_wire(q2, qn, qll, plan.l1, has_n)
            d_r = _unpack_wire(d2, dn, dll, plan.l2, has_n)
            if engine == "cuda":
                (fm, fi, fd), dirs = gotoh_fill_stream_cuda(
                    q_r, d_r, dsums, n2s,
                    plan, scheme, compat, wildcard, dirs_mode,
                )
            else:
                qstream, dstream = _mk_streams(q_r, d_r, plan)
                (fm, fi, fd), dirs = gotoh_fill_stream_lax(
                    qstream, dstream, dsums, n2s,
                    plan, scheme, compat, wildcard, dirs_mode=dirs_mode,
                    state_dtype=sdt,
                )
            finals = jnp.stack(
                [fm.T.reshape(-1), fi.T.reshape(-1), fd.T.reshape(-1)],
                axis=1,
            )
            return finals, dirs

        return body

    def _stream_modes_fill_body(self, plan, mode, has_n, sdt,
                                with_dirs=True):
        """Per-shard streamed MODES fill + device end-cell reduction
        (modes_reduce: 3 ints per pair cross the shard boundary instead
        of 2 * P lanes): returns (best, x, y, dirs) pre-gather.  Shared
        by _stream_modes_fn and the fused modes fill+walk dispatch."""
        scheme, wildcard = self.scheme, self.wildcard

        def body(q2, d2, qn, dn, qll, dll, dsums, n2s):
            q_r = _unpack_wire(q2, qn, qll, plan.l1, has_n)
            d_r = _unpack_wire(d2, dn, dll, plan.l2, has_n)
            qstream, dstream = _mk_streams(q_r, d_r, plan)
            (bv_k, bd_k), dirs = gotoh_fill_stream_modes_lax(
                qstream, dstream, dsums, n2s,
                plan, scheme, wildcard, mode, with_dirs,
                state_dtype=sdt,
            )
            bv = jnp.swapaxes(bv_k, 0, 1).reshape(-1, plan.p)
            bd = jnp.swapaxes(bd_k, 0, 1).reshape(-1, plan.p)
            best, x, y = modes_reduce(bv, bd)
            return best, x, y, dirs

        return body

    def _stream_fn(self, plan, dirs_mode=False, has_n=False):
        sdt = resolve_stream_state(
            self.state_dtype, self.scheme, plan, self.engine(plan)
        )
        key = (
            "stream", plan, self.gather, dirs_mode, jnp.dtype(sdt).name,
            has_n,
        )
        if key in self._fn_cache:
            return self._fn_cache[key]
        gather = self.gather
        fill = self._stream_fill_body(plan, dirs_mode, has_n, sdt)

        def per_shard(*args):
            finals, dirs = fill(*args)
            if gather:
                finals = jax.lax.all_gather(finals, "data", axis=0, tiled=True)
            if dirs_mode:
                # dirs stay row-sharded (huge); the host fetches them per
                # drained batch for traceback.
                return finals, dirs
            return finals

        row = P("data")
        nspec = row if has_n else P()
        slot = P(None, "data")
        out_specs = (
            ((P() if gather else P("data")), P(None, "data"))
            if dirs_mode
            else (P() if gather else P("data"))
        )
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(
                    row, row, nspec, nspec, row, row,
                    slot, slot,
                ),
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn

    def _stream_modes_fn(self, plan, mode: str, with_dirs: bool, has_n=False):
        sdt = resolve_stream_state(self.state_dtype, self.scheme, plan)
        key = (
            "stream_modes", plan, self.gather, mode, with_dirs,
            jnp.dtype(sdt).name, has_n,
        )
        if key in self._fn_cache:
            return self._fn_cache[key]
        gather = self.gather
        # NOTE: the shared body always fills WITH dirs; the with_dirs=False
        # variant below drops them after the fill (XLA dead-code-eliminates
        # the dirs emission when nothing consumes it).
        fill = self._stream_modes_fill_body(plan, mode, has_n, sdt,
                                            with_dirs=with_dirs)

        def per_shard(*args):
            best, x, y, dirs = fill(*args)
            if gather:
                best = jax.lax.all_gather(best, "data", axis=0, tiled=True)
                x = jax.lax.all_gather(x, "data", axis=0, tiled=True)
                y = jax.lax.all_gather(y, "data", axis=0, tiled=True)
            if with_dirs:
                # dirs stay row-sharded (huge); host fetches per batch.
                return best, x, y, dirs
            return best, x, y

        row = P("data")
        nspec = row if has_n else P()
        slot = P(None, "data")
        pair_spec = P() if gather else P("data")
        out_specs = (
            (pair_spec, pair_spec, pair_spec, P(None, "data"))
            if with_dirs
            else (pair_spec, pair_spec, pair_spec)
        )
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(
                    row, row, nspec, nspec, row, row,
                    slot, slot,
                ),
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn

    def fill_modes(self, batch: PairBatch, mode: str, with_dirs: bool = True):
        """Semi-global/local streamed fill on the runner's mesh (textbook
        semantics; ops.nw_affine_stream_modes).  Returns (best[:B],
        best_x[:B], best_y[:B], dirs, plan) -- each pair's end cell,
        reduced on device; walk dirs from (x, y) with
        d_offset = slot * plan.s."""
        if self.kernel != "stream":
            raise ValueError("fill_modes requires kernel='stream'")
        if mode not in ("semi", "local"):
            raise ValueError(f"unknown mode {mode!r}")
        args, plan, B, has_n = self._stream_args(batch)
        out = self._stream_modes_fn(plan, mode, with_dirs, has_n=has_n)(*args)
        if with_dirs:
            best, x, y, dirs = out
        else:
            (best, x, y), dirs = out, None
        return best[:B], x[:B], y[:B], dirs, plan

    def _stream_args_host(self, batch: PairBatch):
        """Host half of _stream_args: trim/pad/wire-pack/capture_params,
        no device traffic.  Returns (host arrays tuple, plan, B, has_n).
        Split out so the streaming pipeline can run it on a producer
        thread that overlaps device execution (and so profiling can
        attribute host prep vs H2D separately).

        Sequences ship 2-bit packed (io.encode.wire_pack_codes) and are
        unpacked on device (_unpack_wire): 4x less H2D traffic at
        bit-identical fill inputs."""
        from sequencealigning_tpu.io.encode import WireBatch, wire_pack_codes

        nd = self.n_devices
        nproc = jax.process_count()
        if isinstance(batch, WireBatch):
            B = batch.size
            L1, L2 = batch.l1, batch.l2
            q2, qn = batch.q2, batch.qn
            d2, dn = batch.d2, batch.dn
            qlen_in = batch.query_len
            dlen_in = batch.db_len
        else:
            batch = trim_for_stream(batch)
            B = batch.query.shape[0]
            L1 = batch.query.shape[1]
            L2 = batch.db.shape[1]
            q2, qn = wire_pack_codes(np.asarray(batch.query))
            d2, dn = wire_pack_codes(np.asarray(batch.db))
            qlen_in = np.asarray(batch.query_len, np.int32)
            dlen_in = np.asarray(batch.db_len, np.int32)
        if nproc > 1:
            # Multi-process: ``batch`` is THIS process's input shard (each
            # host reads only its own slice of the stream); host arrays are
            # built for the local rows only and assembled into global
            # sharded arrays in _put_stream_args.  Pair j of process p is
            # global row-major index p * Bp/nproc + j (mp_local_slice).
            B_total = B * nproc
            NP = max(1, min(self.np_slots, B_total // (8 * nd)))
            Bp_total = round_up(max(B_total, NP * 8 * nd), NP * 8 * nd)
            plan = plan_stream(Bp_total, L1, L2, np_slots=NP)
            assert plan.n_rows % (8 * nd) == 0, (plan, nd)
            Bp = Bp_total // nproc
            assert Bp % NP == 0, (plan, nproc)
        else:
            NP = max(1, min(self.np_slots, B // (8 * nd)))
            Bp = round_up(max(B, NP * 8 * nd), NP * 8 * nd)
            plan = plan_stream(Bp, L1, L2, np_slots=NP)
            assert plan.n_rows % (8 * nd) == 0, (plan, nd)

        def padb(a, w):
            if a.shape[0] == Bp and a.shape[1] == w:
                return np.ascontiguousarray(a, np.uint8)
            out = np.zeros((Bp, w), dtype=np.uint8)
            out[:B] = a
            return out

        def pad32(a, fill):
            out = np.full((Bp,) + a.shape[1:], fill, dtype=np.int32)
            out[:B] = a
            return out

        R = Bp // NP  # local row count (= plan.n_rows unless multiprocess)
        has_n = qn is not None or dn is not None
        q2 = padb(q2, q2.shape[1]).reshape(R, NP, -1)
        d2 = padb(d2, d2.shape[1]).reshape(R, NP, -1)
        if has_n:
            w_q, w_d = -(-L1 // 8), -(-L2 // 8)
            qn = (
                padb(qn, w_q) if qn is not None else np.zeros((Bp, w_q), np.uint8)
            ).reshape(R, NP, -1)
            dn = (
                padb(dn, w_d) if dn is not None else np.zeros((Bp, w_d), np.uint8)
            ).reshape(R, NP, -1)
        else:
            qn = dn = np.zeros((1,), np.uint8)
        qlen = pad32(qlen_in, 1)
        dlen = pad32(dlen_in, 1)
        qll = qlen.reshape(R, NP)
        dll = dlen.reshape(R, NP)
        dsums, n2s = capture_params(qlen, dlen, plan._replace(n_rows=R))
        if nproc > 1:
            B = plan.n_rows * NP  # finals come back global; no local slice
        return (
            (q2, d2, qn, dn, qll, dll, dsums, n2s), plan, B, has_n,
        )

    def _put_stream_args(self, host_args, has_n: bool):
        """device_put the _stream_args_host tuple with the stream shardings.

        Multi-process (jax.distributed): host_args hold only this
        process's row shard; global arrays are assembled from the
        per-process local data (each host touches only its own input --
        the per-host file-shard pattern of BASELINE config 5)."""
        row = NamedSharding(self.mesh, P("data"))
        nshard = row if has_n else NamedSharding(self.mesh, P())
        slot = NamedSharding(self.mesh, P(None, "data"))
        shardings = (
            row, row, nshard, nshard, row, row, slot, slot,
        )
        if jax.process_count() > 1:
            return [
                jax.make_array_from_process_local_data(s, np.asarray(a))
                for a, s in zip(host_args, shardings)
            ]
        return [jax.device_put(a, s) for a, s in zip(host_args, shardings)]

    def mp_local_slice(self, plan) -> slice:
        """Multi-process runs: the slice of the gathered global finals
        holding THIS process's pairs, in its local row-major order
        (pair j of process p = global index p * Bp/nproc + j)."""
        nproc = jax.process_count()
        bp = plan.n_rows * plan.np_slots
        lo = jax.process_index() * (bp // nproc)
        return slice(lo, lo + bp // nproc)

    def _stream_args(self, batch: PairBatch):
        """(device args, plan, B, has_n) for the streamed fill, sharded
        over the mesh's data axis."""
        host_args, plan, B, has_n = self._stream_args_host(batch)
        return self._put_stream_args(host_args, has_n), plan, B, has_n

    def _scores_stream(self, batch: PairBatch):
        args, plan, B, has_n = self._stream_args(batch)
        finals = self._stream_fn(plan, has_n=has_n)(*args)
        return finals[:B]

    def device_walk_fast4_dispatch(self, dirs, plan, finals_dev, n1s, n2s):
        """Dispatch the sharded on-device fast4 walk with NO host sync:
        the per-pair seed plane (M > I > D at the corner) is computed on
        device from the fill's (Bp, 3) finals, so the walk can be queued
        immediately behind its own fill -- BEFORE the next batch's fill
        lands on the device -- and its fetch/decode overlap that fill
        (the streaming pipeline's walk-overlap, VERDICT r3 item 5).

        n1s/n2s: true lengths of the B real pairs.  finals_dev must be
        the UNsliced (Bp, 3) fill output.  Returns opaque handles for
        device_walk_fast4_finish; the dirs tensor stays referenced by
        the handles (the per-pair fallback path needs it)."""
        from sequencealigning_tpu.ops import traceback_device as tbd

        B = len(n1s)
        nd = self.n_devices
        NP, R = plan.np_slots, plan.n_rows
        Bp = NP * R
        # Multi-process: each host knows only its LOCAL pairs' lengths;
        # the (Bp,) walk vectors are assembled from per-process shards
        # (pair j of process p = global row p * Bp/nproc + j,
        # mp_local_slice).  Padding lengths are 1 (a 1-step walk that
        # terminates immediately).
        n_loc = Bp // jax.process_count()
        n1 = np.ones(n_loc, np.int32)
        n2 = np.ones(n_loc, np.int32)
        n1[:B] = n1s
        n2[:B] = n2s
        t_steps = int(plan.l1 + plan.l2)

        # Device-side RLE of the op stream: a production walk is long
        # M-runs split by single edits, so its run-length encoding is
        # ~30-100x smaller than the 2-bit stream.  OFF by default
        # (SEQALIGN_RLE=1 opts in): the streaming pipeline already hides
        # the packed fetch under the next batch's fill, and the pack costs
        # device time plus one extra fetch round trip; its time on the
        # GPU is not measured.  Gated on the u16 run-length range
        # of the PADDED step count T = ceil(t_steps/_CHUNK)*_CHUNK
        # (rle_pack_ops emits uint16 lens; a T-length run at T == 65536
        # would wrap to 0).  Overflow pairs (> RLE_CAP runs) fall back
        # to their full packed row at finish().
        import os as _os

        nproc = jax.process_count()
        t_padded = -(-t_steps // tbd._CHUNK) * tbd._CHUNK
        # Multi-process finish drains per-shard packed rows directly;
        # the RLE variant is single-process only.
        use_rle = (
            t_padded <= 0xFFFF
            and nproc == 1
            and _os.environ.get("SEQALIGN_RLE", "") not in ("", "0")
        )

        key = ("walk", plan, use_rle)
        if key not in self._fn_cache:

            def per_shard(dirs_l, fin_l, x0, y0, rowp, offp):
                # Seed plane on device (ops.traceback_device.seed_planes'
                # rule): priority M > I > D at each pair's corner score.
                score = jnp.max(fin_l, axis=1)
                pl0 = jnp.where(
                    fin_l[:, 0] == score,
                    0,
                    jnp.where(fin_l[:, 1] == score, 1, 2),
                ).astype(jnp.int32)
                (x, y), packed, n = tbd._walk_fast4_impl(
                    dirs_l, x0, y0, pl0, rowp, offp, t_steps=t_steps
                )
                # All-shard max of chunks used: finish() fetches only
                # that prefix of the packed op words (typical walks use
                # ~half of t_steps, and the packed fetch is the drain's
                # biggest D2H cost on a slow link).
                n = jax.lax.pmax(n, "data")
                if not use_rle:
                    return (x, y), packed, n
                vals, lens, n_runs = tbd.rle_pack_ops(packed)
                return (x, y), packed, n, (vals, lens, n_runs)

            pb = P("data")
            rle_spec = (
                ((P("data", None), P("data", None), pb),) if use_rle else ()
            )
            self._fn_cache[key] = jax.jit(
                jax.shard_map(
                    per_shard,
                    mesh=self.mesh,
                    in_specs=(P(None, "data", None), pb, pb, pb, pb, pb),
                    out_specs=((pb, pb), P("data", None), P())
                    + rle_spec,
                    check_vma=False,
                )
            )
        rowd, offd = self._walk_coords(plan)
        # ONE fused put for the per-batch lengths (each device_put pays a
        # full host-to-device latency).
        n21_sharding = NamedSharding(self.mesh, P(None, "data"))
        if nproc > 1:
            n21 = jax.make_array_from_process_local_data(
                n21_sharding, np.stack([n2, n1])
            )
        else:
            n21 = jax.device_put(np.stack([n2, n1]), n21_sharding)
        out = self._fn_cache[key](
            dirs, finals_dev, n21[0], n21[1], rowd, offd
        )
        (xf, yf), packed, n_used = out[0], out[1], out[2]
        rle = out[3] if len(out) > 3 else None
        return (xf, yf, packed, dirs, plan, n_used, rle)

    def _walk_coords(self, plan):
        """Per-plan device cache of the walk's shard-local row / lane
        offset vectors (constants of the plan + mesh, not the batch).
        Multi-process: each host materializes only its slice of the
        global pair-index range and the sharded vectors are assembled
        from per-process local data."""
        key = ("walk_coords", plan)
        if key not in self._fn_cache:
            nd = self.n_devices
            nproc = jax.process_count()
            NP, R = plan.np_slots, plan.n_rows
            n_loc = NP * R // nproc
            lo = jax.process_index() * n_loc
            bs = np.arange(lo, lo + n_loc)
            rowloc = ((bs // NP) % (R // nd)).astype(np.int32)
            off = ((bs % NP) * plan.s).astype(np.int32)
            shard = NamedSharding(self.mesh, P("data"))
            if nproc > 1:
                mk = lambda a: jax.make_array_from_process_local_data(
                    shard, a
                )
            else:
                mk = lambda a: jax.device_put(a, shard)
            self._fn_cache[key] = (mk(rowloc), mk(off))
        return self._fn_cache[key]

    def device_walk_fast4_finish(self, handles, finals, seqs1, seqs2):
        """Fetch + decode a dispatched device walk.  finals: (>=B, 3)
        host finals (for result scores and the fallback walker).  Returns
        a traceback_stream_batch-shaped list: (score, [(a1, a2)]) or
        AlignmentError per pair; a pair whose device walk fails
        validation falls back to fetching its single dirs row."""
        from sequencealigning_tpu.errors import AlignmentError
        from sequencealigning_tpu.ops import traceback_device as tbd
        from sequencealigning_tpu.ops.traceback import fast4_traceback_pair

        xf, yf, packed, dirs, plan, n_used, rle = handles
        finals = np.asarray(finals)
        if jax.process_count() > 1:
            return self._device_walk_finish_mp(handles, finals, seqs1, seqs2)
        B = len(seqs1)
        big = B * packed.shape[1] * 4 >= (1 << 21)
        if rle is not None and big:
            # RLE drain: fetch the run counts with the end coords (one
            # round trip), then only the used run prefix -- ~100x fewer
            # bytes than the 2-bit op stream at production divergence.
            # Pairs with > RLE_CAP runs refetch their full packed row.
            vals_d, lens_d, n_runs_d = rle
            xf, yf, n_runs = jax.device_get(
                (xf[:B], yf[:B], n_runs_d[:B])
            )
            rmax = min(max(int(n_runs.max(initial=1)), 1), tbd.RLE_CAP)
            vals, lens = jax.device_get(
                (vals_d[:B, :rmax], lens_d[:B, :rmax])
            )
            packed_h = tbd.rle_expand_packed(vals, lens, packed.shape[1])
            over = np.flatnonzero(n_runs > tbd.RLE_CAP)
            for i in over:
                packed_h[i] = np.asarray(packed[i])
            self.last_drain_path = "rle"
            self.last_drain_bytes = (
                B * (4 + 4 + 4)  # xf, yf, n_runs int32
                + B * rmax * (1 + 2)  # vals u8 + lens u16
                + over.size * packed.shape[1] * 4
            )
        else:
            # Two-phase fetch -- the scalar chunk count first, then only
            # the used prefix of the packed op words -- only when the
            # full buffer is big enough that the halved bulk beats the
            # extra round-trip latency.
            if big:
                wpc = tbd._CHUNK // 16
                words = max(int(n_used), 1) * wpc
                packed = packed[:, :words]
            packed_h, xf, yf = jax.device_get(
                (packed[:B], xf[:B], yf[:B])
            )
            self.last_drain_path = "packed"
            self.last_drain_bytes = B * (packed.shape[1] * 4 + 4 + 4)
        alns = tbd.decode_packed_alignments(packed_h, seqs1, seqs2)
        ended = (xf == 0) & (yf == 0)
        out = []
        for b in range(B):
            if alns[b] is None or not ended[b]:
                row, _slot, doff = plan.pair_coords(b)
                try:
                    out.append(
                        fast4_traceback_pair(
                            np.asarray(dirs[:, row, :]), finals[b],
                            seqs1[b], seqs2[b], compat=self.compat,
                            d_offset=doff,
                        )
                    )
                except AlignmentError as e:
                    out.append(e)
                continue
            out.append((int(finals[b].max()), [alns[b]]))
        return out

    @staticmethod
    def _local_row_shards(arr, dim: int = 0):
        """This process's addressable shards of a global array sharded
        on ``dim``, sorted by their global start index on that dim:
        [(start, single-device jax.Array), ...]."""
        def start(s):
            sl = s.index[dim]
            return sl.start or 0

        return [
            (start(s), s.data)
            for s in sorted(arr.addressable_shards, key=start)
        ]

    def _device_walk_finish_mp(self, handles, finals, seqs1, seqs2):
        """Multi-process device_walk_fast4_finish: every host fetches
        ONLY its addressable row shards of the walk outputs (packed op
        words, end coords) and decodes its OWN pairs -- no packed-op row
        ever crosses a process boundary, which is what made the cigars
        path scores-only across processes in round 4 (the config-5
        "2-host" gap, BASELINE.md §5).  finals: the GLOBAL gathered
        (Bp, 3) host finals (the runner's all_gather merge); seqs1/seqs2:
        this process's local pairs.  Returns local per-pair results in
        local order (per-process on_alignments contract)."""
        from sequencealigning_tpu.errors import AlignmentError
        from sequencealigning_tpu.ops import traceback_device as tbd
        from sequencealigning_tpu.ops.traceback import fast4_traceback_pair

        xf, yf, packed, dirs, plan, n_used, _rle = handles
        B = len(seqs1)
        loc = self.mp_local_slice(plan)
        finals_l = finals[loc][:B] if finals.shape[0] > B else finals[:B]
        # Used-prefix trim per addressable shard BEFORE the fetch (the
        # while_loop's all-shard pmax makes n_used replicated, so every
        # process sees the same prefix).
        wpc = tbd._CHUNK // 16
        words = max(int(np.asarray(n_used)), 1) * wpc
        packed_l = np.concatenate(
            [
                np.asarray(d[:, :words])
                for _s, d in self._local_row_shards(packed, dim=0)
            ],
            axis=0,
        )[:B]
        xf_l = np.concatenate(
            [np.asarray(d) for _s, d in self._local_row_shards(xf)]
        )[:B]
        yf_l = np.concatenate(
            [np.asarray(d) for _s, d in self._local_row_shards(yf)]
        )[:B]
        self.last_drain_path = "packed-mp"
        self.last_drain_bytes = B * (words * 4 + 4 + 4)
        alns = tbd.decode_packed_alignments(packed_l, seqs1, seqs2)
        ended = (xf_l == 0) & (yf_l == 0)
        dirs_shards = self._local_row_shards(dirs, dim=1)
        lo = loc.start
        out = []
        for b in range(B):
            if alns[b] is None or not ended[b]:
                # Fallback: host-walk this pair from its single dirs row,
                # fetched from the addressable shard that holds it.
                row, _slot, doff = plan.pair_coords(lo + b)
                dirs_row = None
                for start, data in dirs_shards:
                    if start <= row < start + data.shape[1]:
                        dirs_row = np.asarray(data[:, row - start, :])
                        break
                if dirs_row is None:  # pragma: no cover - layout invariant
                    out.append(AlignmentError(
                        "walk failed and its dirs row is not addressable "
                        "from this process"
                    ))
                    continue
                try:
                    out.append(
                        fast4_traceback_pair(
                            dirs_row, finals_l[b], seqs1[b], seqs2[b],
                            compat=self.compat, d_offset=doff,
                        )
                    )
                except AlignmentError as e:
                    out.append(e)
                continue
            out.append((int(finals_l[b].max()), [alns[b]]))
        return out

    def device_walk_fast4(self, dirs, plan, finals, seqs1, seqs2):
        """On-device fast4 traceback over the runner's row-sharded dirs
        tensor (fill_with_dirs output): each device walks exactly the
        pairs whose rows it holds (shard_map over 'data'; pair order is
        row-major, so pair blocks align with row shards), and only the
        2-bit packed op codes cross the device boundary (~(l1+l2)/4
        bytes/pair vs the 0.5 byte/cell dirs fetch of the host path).

        Synchronous wrapper over dispatch + finish (the streaming
        pipeline uses those directly to overlap the walk with the next
        batch's fill)."""
        finals = np.asarray(finals)
        B = len(seqs1)
        NP, R = plan.np_slots, plan.n_rows
        fin_full = np.zeros((NP * R, 3), np.int32)
        fin_full[:B] = finals[:B]
        handles = self.device_walk_fast4_dispatch(
            dirs, plan, fin_full,
            [len(s) for s in seqs1], [len(s) for s in seqs2],
        )
        return self.device_walk_fast4_finish(handles, finals, seqs1, seqs2)

    def device_walk_modes_dispatch(self, dirs, plan, x_dev, y_dev,
                                   mode: str):
        """Dispatch the sharded on-device modes walk with NO host sync:
        the end cells (x_dev, y_dev) stay device arrays straight from the
        modes fill (full (Bp,) slot vectors, fill_modes' unsliced x/y),
        so the walk queues immediately behind its own fill and the
        streaming pipeline's next fill overlaps its fetch/decode --
        exactly device_walk_fast4_dispatch's protocol for the textbook
        modes.  Returns opaque handles for device_walk_modes_finish."""
        from sequencealigning_tpu.ops import traceback_device as tbd

        local = mode == "local"
        t_steps = int(plan.l1 + plan.l2)

        key = ("walk_modes", plan, local)
        if key not in self._fn_cache:

            def per_shard(dirs_l, x_, y_, rowp_, off_):
                (x, y, st), packed, _n = tbd._walk_modes_impl(
                    dirs_l, x_, y_, rowp_, off_, local=local,
                    t_steps=t_steps,
                )
                return (x, y, st), packed

            pb = P("data")
            self._fn_cache[key] = jax.jit(
                jax.shard_map(
                    per_shard,
                    mesh=self.mesh,
                    in_specs=(P(None, "data", None), pb, pb, pb, pb),
                    out_specs=((pb, pb, pb), P("data", None)),
                    check_vma=False,
                )
            )
        shard = NamedSharding(self.mesh, P("data"))
        xd = jax.device_put(jnp.asarray(x_dev, jnp.int32), shard)
        yd = jax.device_put(jnp.asarray(y_dev, jnp.int32), shard)
        rowd, offd = self._walk_coords(plan)
        (xf, yf, st), packed = self._fn_cache[key](dirs, xd, yd, rowd, offd)
        return (xf, yf, st, packed, xd, yd, dirs, plan, local)

    def device_walk_modes_finish(self, handles, seqs1, seqs2):
        """Fetch + decode a dispatched modes walk (one fused device_get
        for the op codes, stop state, and end cells).  Returns, per pair,
        the walked segment (mid1, mid2, stop_x, stop_y) or None where the
        walk failed validation (caller falls back to the host walkers on
        a fetched dirs row).

        Multi-process: each host fetches only its addressable row shards
        of the walk outputs and decodes its OWN pairs (the modes analog
        of _device_walk_finish_mp); end cells may arrive replicated
        (the fused fill+walk path's all_gather) or row-sharded."""
        from sequencealigning_tpu.ops import traceback_device as tbd

        xf, yf, st, packed, xd, yd, dirs, plan, local = handles
        B = len(seqs1)
        if jax.process_count() > 1:
            loc = self.mp_local_slice(plan)

            def local_vals(arr):
                a = arr
                if isinstance(a, np.ndarray) or getattr(
                    a, "is_fully_replicated", False
                ):
                    return np.asarray(a)[loc][:B]
                return np.concatenate(
                    [np.asarray(d) for _s, d in self._local_row_shards(a)]
                )[:B]

            packed_l = np.concatenate(
                [
                    np.asarray(d)
                    for _s, d in self._local_row_shards(packed, dim=0)
                ],
                axis=0,
            )[:B]
            xf_l, yf_l, st_l = (
                local_vals(xf), local_vals(yf), local_vals(st)
            )
            return tbd.decode_modes_walk(
                packed_l, xf_l, yf_l, st_l,
                local_vals(xd).astype(np.int32),
                local_vals(yd).astype(np.int32),
                seqs1, seqs2,
            )
        packed, xf, yf, st, x0, y0 = jax.device_get(
            (packed[:B], xf[:B], yf[:B], st[:B], xd[:B], yd[:B])
        )
        return tbd.decode_modes_walk(
            packed, xf, yf, st,
            np.asarray(x0, np.int32), np.asarray(y0, np.int32),
            seqs1, seqs2,
        )

    def device_walk_modes(
        self, dirs, plan, best_x, best_y, seqs1, seqs2, mode: str
    ):
        """Sharded on-device walk over fill_modes' row-sharded full-byte
        dirs (mirrors device_walk_fast4).  Synchronous wrapper over
        dispatch + finish; best_x/best_y may be host or device arrays
        sized >= B (padded to the Bp slot grid here)."""
        NP, R = plan.np_slots, plan.n_rows
        Bp = NP * R
        B = len(seqs1)
        x0 = np.zeros(Bp, np.int32)
        y0 = np.zeros(Bp, np.int32)
        x0[:B] = np.asarray(best_x[:B], np.int32)
        y0[:B] = np.asarray(best_y[:B], np.int32)
        handles = self.device_walk_modes_dispatch(dirs, plan, x0, y0, mode)
        return self.device_walk_modes_finish(handles, seqs1, seqs2)

    def fill_with_dirs(self, batch: PairBatch, dirs_mode: str = "fast4"):
        """Streamed fill WITH direction words, on the runner's mesh (the
        round-1 cigars path silently ran single-device): returns
        (finals[:B] -- gathered per self.gather, dirs -- row-sharded device
        array in the stream layout, plan).  Host traceback:
        ops.traceback.traceback_stream_batch(np.asarray(dirs), ...)."""
        if self.kernel != "stream":
            raise ValueError("fill_with_dirs requires kernel='stream'")
        args, plan, B, has_n = self._stream_args(batch)
        finals, dirs = self._stream_fn(plan, dirs_mode=dirs_mode, has_n=has_n)(
            *args
        )
        return finals[:B], dirs, plan

    def scores_from_stream_args(self, args, plan, B: int, has_n: bool):
        """Dispatch the streamed score fill on args already device_put
        (producer-thread pipeline: parallel.streaming overlaps the host
        prep + H2D of batch k+1 with the device execution of batch k)."""
        return self._stream_fn(plan, has_n=has_n)(*args)[:B]

    def fill_with_dirs_from_stream_args(
        self, args, plan, B: int, has_n: bool, dirs_mode: str = "fast4"
    ):
        """fill_with_dirs on args already device_put (see scores_from_stream_args)."""
        finals, dirs = self._stream_fn(plan, dirs_mode=dirs_mode, has_n=has_n)(
            *args
        )
        return finals[:B], dirs, plan

    def _fill_walk_fused_fn(self, plan, has_n: bool):
        """ONE jitted shard_map running the streamed fast4 fill AND the
        on-device walk of its dirs tensor back-to-back per shard.

        Fusing them into one program turns a fill call, a walk call and
        the walk's per-batch length device_put into ONE dispatch: the
        walk's length vectors come from the stream args the fill
        already shipped (qll/dll, padded with length 1 = immediate-stop
        walks, exactly the dispatch path's convention), and the walk's
        shard-local (row, lane-offset) coordinate vectors are iota
        functions of the pair index -- no extra inputs at all."""
        from sequencealigning_tpu.ops import traceback_device as tbd
        sdt = resolve_stream_state(
            self.state_dtype, self.scheme, plan, self.engine(plan)
        )
        import os as _os

        t_steps = int(plan.l1 + plan.l2)
        t_padded = -(-t_steps // tbd._CHUNK) * tbd._CHUNK
        use_rle = (
            t_padded <= 0xFFFF
            and jax.process_count() == 1
            and _os.environ.get("SEQALIGN_RLE", "") not in ("", "0")
        )
        key = (
            "fill_walk", plan, self.gather, jnp.dtype(sdt).name, has_n,
            use_rle,
        )
        if key in self._fn_cache:
            return self._fn_cache[key], use_rle
        gather = self.gather
        NP = plan.np_slots
        fill = self._stream_fill_body(plan, "fast4", has_n, sdt)

        def per_shard(*shard_args):
            (q2, d2, qn, dn, qll, dll, dsums, n2s) = shard_args
            finals, dirs = fill(*shard_args)
            # Walk seeds from the LOCAL (pre-gather) finals + the stream
            # args' true lengths (pair b = row b // NP, slot b % NP, so
            # the (R_loc, NP) length grids flatten straight into pair
            # order; padding slots carry length 1).
            n1 = qll.reshape(-1)
            n2 = dll.reshape(-1)
            bs = jnp.arange(n1.shape[0], dtype=jnp.int32)
            rowp = bs // NP
            offp = (bs % NP) * plan.s
            score = jnp.max(finals, axis=1)
            pl0 = jnp.where(
                finals[:, 0] == score,
                0,
                jnp.where(finals[:, 1] == score, 1, 2),
            ).astype(jnp.int32)
            (x, y), packed, n = tbd._walk_fast4_impl(
                dirs, n2, n1, pl0, rowp, offp, t_steps=t_steps
            )
            n = jax.lax.pmax(n, "data")
            if gather:
                finals = jax.lax.all_gather(
                    finals, "data", axis=0, tiled=True
                )
            out = (finals, (x, y), packed, n, dirs)
            if use_rle:
                out = out + (tbd.rle_pack_ops(packed),)
            return out

        row = P("data")
        nspec = row if has_n else P()
        slot = P(None, "data")
        pb = P("data")
        out_specs = (
            (P() if gather else pb),
            (pb, pb),
            P("data", None),
            P(),
            P(None, "data", None),
        )
        if use_rle:
            out_specs = out_specs + (
                (P("data", None), P("data", None), pb),
            )
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(
                    row, row, nspec, nspec, row, row,
                    slot, slot,
                ),
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn, use_rle

    def fill_walk_from_stream_args(self, args, plan, B: int, has_n: bool,
                                   seqs1, seqs2):
        """Streamed fast4 fill AND its device walk as ONE fused dispatch
        on args already device_put: the walk lands on the device queue
        inside the same program as its fill, so its packed-op fetch and
        host decode overlap the next batch's fill -- and the main thread
        pays a single dispatch per batch instead of three
        (fill call + walk call + length device_put; see
        _fill_walk_fused_fn).  Returns (finals[:B] lazy, walk handles
        for device_walk_fast4_finish)."""
        fn, use_rle = self._fill_walk_fused_fn(plan, has_n)
        out = fn(*args)
        finals, (xf, yf), packed, n_used, dirs = out[:5]
        rle = out[5] if use_rle else None
        handles = (xf, yf, packed, dirs, plan, n_used, rle)
        return finals[:B], handles

    def _fill_walk_modes_fused_fn(self, plan, mode: str, has_n: bool):
        """Modes analog of _fill_walk_fused_fn: the streamed textbook
        fill (semi/local), its device end-cell reduction, AND the modes
        walk in ONE jitted shard_map -- the separate walk dispatch and
        its end-cell device_put round trips disappear (the walk seeds
        straight from the per-shard modes_reduce output)."""
        from sequencealigning_tpu.ops import traceback_device as tbd
        sdt = resolve_stream_state(self.state_dtype, self.scheme, plan)
        local = mode == "local"
        t_steps = int(plan.l1 + plan.l2)
        key = (
            "fill_walk_modes", plan, self.gather, mode,
            jnp.dtype(sdt).name, has_n,
        )
        if key in self._fn_cache:
            return self._fn_cache[key]
        gather = self.gather
        NP = plan.np_slots
        fill = self._stream_modes_fill_body(plan, mode, has_n, sdt)

        def per_shard(*shard_args):
            best, x, y, dirs = fill(*shard_args)
            bs = jnp.arange(x.shape[0], dtype=jnp.int32)
            rowp = bs // NP
            offp = (bs % NP) * plan.s
            (xf, yf, st), packed, _n = tbd._walk_modes_impl(
                dirs, x, y, rowp, offp, local=local, t_steps=t_steps
            )
            if gather:
                best = jax.lax.all_gather(best, "data", axis=0, tiled=True)
                x = jax.lax.all_gather(x, "data", axis=0, tiled=True)
                y = jax.lax.all_gather(y, "data", axis=0, tiled=True)
            return best, x, y, (xf, yf, st), packed, dirs

        row = P("data")
        nspec = row if has_n else P()
        slot = P(None, "data")
        pair_spec = P() if gather else P("data")
        pb = P("data")
        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(
                    row, row, nspec, nspec, row, row,
                    slot, slot,
                ),
                out_specs=(
                    pair_spec, pair_spec, pair_spec,
                    (pb, pb, pb), P("data", None),
                    P(None, "data", None),
                ),
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn

    def fill_walk_modes_from_stream_args(
        self, args, plan, B: int, has_n: bool, mode: str
    ):
        """Textbook-mode (semi/local) streamed fill AND its device modes
        walk as ONE fused dispatch on args already device_put -- the
        modes analog of fill_walk_from_stream_args: no host sync or
        extra round trips between fill and walk, the walk's op-code
        fetch + decode overlap the next batch's fill, and the dirs
        tensor NEVER crosses the device boundary on the happy path
        (VERDICT r3 item 9).  Returns (best[:B] lazy device array,
        x[:B], y[:B], walk handles for device_walk_modes_finish, dirs,
        plan)."""
        if mode not in ("semi", "local"):
            raise ValueError(f"unknown mode {mode!r}")
        fn = self._fill_walk_modes_fused_fn(plan, mode, has_n)
        best, x, y, (xf, yf, st), packed, dirs = fn(*args)
        handles = (
            xf, yf, st, packed, x, y, dirs, plan, mode == "local"
        )
        return best[:B], x[:B], y[:B], handles, dirs, plan

    def fill_modes_from_stream_args(
        self, args, plan, B: int, has_n: bool, mode: str,
        with_dirs: bool = True,
    ):
        """fill_modes on args already device_put (host-walk route of the
        modes streaming path; see fill_walk_modes_from_stream_args)."""
        out = self._stream_modes_fn(plan, mode, with_dirs, has_n=has_n)(
            *args
        )
        if with_dirs:
            best, x, y, dirs = out
        else:
            (best, x, y), dirs = out, None
        return best[:B], x[:B], y[:B], dirs, plan

    def scores(self, batch: PairBatch):
        """Returns (B, 3) int32 finals (M/I/D at each pair's corner).

        The batch size is padded up to a multiple of 8 * n_devices
        (kernel='stream' pads to np_slots * 8 * n_devices).
        """
        if self.kernel == "stream":
            return self._scores_stream(batch)
        nd = self.n_devices
        B = batch.query.shape[0]
        Bp = round_up(max(B, 8 * nd), 8 * nd)
        L1 = batch.query.shape[1]
        L2 = batch.db.shape[1]
        P_ = round_up(L2 + 1, 128)

        def pad(a, fill=0):
            out = np.full((Bp,) + a.shape[1:], fill, dtype=a.dtype)
            out[:B] = a
            return out

        query = pad(np.asarray(batch.query, np.int32))
        s2v = np.zeros((Bp, P_), np.int32)
        s2v[:B, 1 : L2 + 1] = batch.db
        dlen = pad(np.asarray(batch.db_len, np.int32))
        qlen = pad(np.asarray(batch.query_len, np.int32))
        dsum = (qlen + dlen)[:, None].astype(np.int32)
        n2mask = (
            np.arange(P_, dtype=np.int32)[None, :] == dlen[:, None]
        ).astype(np.int32)

        fn = self._sharded_fn(L1, L2, P_)
        sharding = NamedSharding(self.mesh, P("data"))
        args = [
            jax.device_put(a, sharding)
            for a in (query, s2v, dsum, n2mask)
        ]
        finals = fn(*args)
        # Returned as a (lazy) device array so callers can pipeline; slice
        # off the batch padding.
        return finals[:B]
