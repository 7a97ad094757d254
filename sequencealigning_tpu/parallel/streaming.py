"""Streaming alignment pipeline for very large pair sets.

BASELINE config 5: 1M read pairs streamed data-parallel over a multi-host
slice.  The host pipeline keeps the device fed: JAX dispatch is asynchronous,
so enqueueing the next batch while the previous one executes gives
double-buffering for free; a bounded in-flight window applies backpressure.
Each host streams its own shard of the input (per-host file shards in a
multi-host run); the score merge is the runner's all_gather.

A batch-cursor checkpoint (the index of the last completed batch) supports
resume for long runs -- the checkpoint/restart story the reference lacks
(SURVEY.md §5)."""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.parallel.runner import DataParallelRunner


def stream_align(
    pairs: Iterable[Tuple[bytes, bytes]],
    runner: Optional[DataParallelRunner] = None,
    batch_size: int = 256,
    max_in_flight: int = 2,
    checkpoint_path: Optional[str] = None,
    on_result: Optional[Callable[[int, np.ndarray], None]] = None,
    cigars: bool = False,
    on_alignments: Optional[Callable[[int, list], None]] = None,
    first_batch_index: int = 0,
    mode: str = "global",
) -> int:
    """Stream pairs through the runner.  Returns the number of pairs aligned.

    ``pairs`` is either an iterable of (query, db) byte tuples (chunked
    and packed here, ~5-10 us/pair of host work) or an iterable of
    pre-packed PairBatch objects (io.encode.pack_arrays -- the
    vectorized fast path for array-shaped input; scores only, since the
    cigar traceback needs the raw byte sequences).

    on_result(batch_index, scores) is called per completed batch (scores:
    (B, 3) finals).  Callbacks fire on the pipeline's single DRAIN
    worker thread (r5: the result fetch + decode run off the main
    thread so the next batch's dispatch never waits behind them), in
    batch order; they must not assume the caller's thread.  If checkpoint_path is given, completed-batch indices
    are persisted and already-completed batches are skipped on resume
    (at-least-once delivery: the batch in flight when a run is interrupted
    is re-delivered, so callbacks must be idempotent).

    first_batch_index declares that ``pairs`` already starts at that
    batch index (production resume: the reader seeks past completed
    input instead of regenerating it; batch i of the stream is numbered
    first_batch_index + i for callbacks and the checkpoint cursor).

    With cigars=True each batch also runs the fast4 direction fill and a
    host first-path traceback; on_alignments(batch_index, results) receives
    per-pair (score, [(aligned_query, aligned_db)]) tuples or
    AlignmentError instances.  Multi-process runs stream cigars too (the
    sharded device walk + per-process packed-op drains,
    runner._device_walk_finish_mp): each process's on_alignments receives
    ITS OWN pairs' alignments in local order, while on_result keeps the
    globally gathered scores.  The cigar fill runs through the runner's
    mesh like the scores path (runner.fill_with_dirs: per-shard fills,
    row-sharded dirs) and dispatch stays asynchronous -- the dirs fetch
    (~0.5 byte per DP cell to the host) happens at drain time.  At extreme
    scale stream scores only, or use the banded engine.

    ``mode`` selects the alignment semantics: "global" (default; fast4
    layout) or the textbook modes "semi" / "local"
    (ops.nw_affine_stream_modes fills on the runner's mesh).  With
    cigars=True the modes route dispatches the sharded on-device modes
    walk back-to-back with each fill (runner.fill_walk_modes_from_
    stream_args): only 2-bit op codes cross the device boundary, the
    walk's fetch/decode overlap the next batch's fill, and on_result
    receives (B,) best scores instead of (B, 3) finals.
    """
    if mode not in ("global", "semi", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    runner = runner or DataParallelRunner()
    start_batch = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            ckpt = json.load(f)
        start_batch = ckpt.get("next_batch", 0)
        # Refuse to resume under different alignment semantics: a
        # checkpoint written by a global scores-only run must not be
        # continued as e.g. a local cigars run -- the one output stream
        # would silently mix semantics across the resume point.  (Old
        # checkpoints without the fields resume as before.)
        for field, now in (("mode", mode), ("cigars", cigars)):
            then = ckpt.get(field, now)
            if then != now:
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} was written by a "
                    f"run with {field}={then!r}; resuming with "
                    f"{field}={now!r} would mix alignment semantics in "
                    "one output stream (delete the checkpoint to start "
                    "over)"
                )

    n_done = [0]  # drained-pair count (owned by the drain worker)

    def _drain(entry):
        idx, scores, n_slice, n_count, extra = entry
        scores = np.asarray(scores)  # blocks until ready
        n_done[0] += n_count
        if on_result is not None:
            on_result(idx, scores[:n_slice])
        if extra is not None and on_alignments is not None:
            if extra[0] == "modes":
                # Textbook-mode streaming: finish the pre-dispatched
                # sharded modes walk (op-code fetch + decode overlap the
                # next fill); per-pair fallbacks fetch ONE dirs row.
                from sequencealigning_tpu.ops.traceback_device import (
                    assemble_modes_alignments,
                )

                (_, handles, seqs1, seqs2, xs, ys, dirs, plan) = extra
                walked = (
                    runner.device_walk_modes_finish(handles, seqs1, seqs2)
                    if handles is not None else None
                )
                xs, ys = np.asarray(xs), np.asarray(ys)
                sc = scores[:, 0] if scores.ndim > 1 else scores
                g_lo = 0
                if _mp():
                    # Per-process view of the replicated best/end-cell
                    # vectors; the fallback fetch below addresses only
                    # this process's dirs row shards.
                    loc = runner.mp_local_slice(plan)
                    nB = len(seqs1)
                    xs, ys, sc = (
                        xs[loc][:nB], ys[loc][:nB], sc[loc][:nB]
                    )
                    g_lo = loc.start
                dirs_host: dict = {}

                def dirs_fetch(b):
                    row, _slot, d_off = plan.pair_coords(g_lo + b)
                    if _mp():
                        for start, data in runner._local_row_shards(
                            dirs, dim=1
                        ):
                            if start <= row < start + data.shape[1]:
                                return (
                                    np.asarray(data[:, row - start, :]),
                                    d_off,
                                )
                        raise RuntimeError(
                            "dirs row not addressable from this process"
                        )
                    if walked is None:
                        # Host route: one whole-tensor fetch, cached.
                        if "all" not in dirs_host:
                            dirs_host["all"] = np.asarray(dirs)
                        return dirs_host["all"][:, row, :], d_off
                    return np.asarray(dirs[:, row, :]), d_off

                tbs = assemble_modes_alignments(
                    list(zip(seqs1, seqs2)), walked, sc, xs, ys,
                    mode == "local", dirs_fetch,
                )
            elif len(extra) == 3:
                # Pre-dispatched device walk (stream-args path): only the
                # fetch + decode remain, overlapping the next fill.
                handles, seqs1, seqs2 = extra
                tbs = runner.device_walk_fast4_finish(
                    handles, scores, seqs1, seqs2
                )
            else:
                dirs, plan, seqs1, seqs2 = extra
                from sequencealigning_tpu.ops.traceback_device import (
                    use_device_walk,
                )

                if use_device_walk(runner):
                    # Walk on device, sharded like the fill (each device
                    # walks its own rows' pairs); only 2-bit op codes are
                    # fetched instead of the dirs tensor.
                    tbs = runner.device_walk_fast4(
                        dirs, plan, scores, seqs1, seqs2
                    )
                else:
                    from sequencealigning_tpu.ops.traceback import (
                        traceback_stream_batch,
                    )

                    tbs = traceback_stream_batch(
                        np.asarray(dirs), scores, seqs1, seqs2, plan,
                        compat=runner.compat, dirs_mode="fast4",
                    )
            on_alignments(idx, tbs)
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"next_batch": idx + 1, "mode": mode, "cigars": cigars},
                    f,
                )
            os.replace(tmp, checkpoint_path)

    from sequencealigning_tpu.io.encode import PairBatch, WireBatch

    def _batches():
        """Yield (index, PairBatch or None, pair bytes or None).  Callers
        whose input is already array-shaped can yield PairBatch objects
        directly (built with io.encode.pack_arrays -- no per-pair Python
        loop); byte-pair input is chunked here and packed by the caller
        AFTER the resume skip (so resumed runs don't re-pack
        already-completed batches)."""
        it = iter(pairs)
        first = next(it, None)
        if first is None:
            return
        import itertools

        chained = itertools.chain([first], it)
        if isinstance(first, (PairBatch, WireBatch)):
            for i, b in enumerate(chained, start=first_batch_index):
                yield i, b, None
            return
        for i, bp in enumerate(
            _chunks(chained, batch_size), start=first_batch_index
        ):
            yield i, None, bp

    # Four-stage pipeline: [prep thread: pack + host CPU work] ->
    # [put thread: device_put (PCIe I/O, GIL-free)] -> [this thread:
    # dispatch only] -> [drain thread: result fetch + decode +
    # callbacks].  The host timeline can bind this loop (pack + prep +
    # H2D against a fast fill); splitting CPU work, transfers, and the
    # drain from dispatch lets each overlap device execution even on a
    # single host core.  Bounded queues keep backpressure identical to
    # max_in_flight.
    stream_kernel = runner.kernel == "stream"
    depth = max(1, max_in_flight)
    q_prep: "queue.Queue" = queue.Queue(maxsize=depth)
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def prep():
        try:
            for i, batch, batch_pairs in _batches():
                if i < start_batch:
                    continue
                if batch is None:
                    batch = pack_batch(batch_pairs, batch_size=batch_size)
                n_valid = int(batch.valid.sum())
                if stream_kernel:
                    host_args, plan, B, has_n = runner._stream_args_host(
                        batch
                    )
                    q_prep.put(("host", i, host_args, plan, B, has_n,
                                n_valid, batch_pairs))
                else:
                    q_prep.put(("batch", i, batch, n_valid, batch_pairs))
            q_prep.put(("done",))
        except BaseException as e:  # propagate downstream
            q_prep.put(("error", e))

    def put():
        while True:
            item = q_prep.get()
            if item[0] == "host":
                _, i, host_args, plan, B, has_n, n_valid, batch_pairs = item
                try:
                    args = runner._put_stream_args(host_args, has_n)
                except BaseException as e:
                    q.put(("error", e))
                    return
                q.put(("args", i, args, plan, B, has_n, n_valid,
                       batch_pairs))
            else:
                q.put(item)  # batch / done / error pass through
                if item[0] in ("done", "error"):
                    return

    # Drain worker: device_get + decode + callbacks run OFF the main
    # thread, so batch k+1's dispatch never waits behind batch k's fetch
    # (the two serialize on the link, but the main thread stays free to
    # keep the device queue full).  One worker preserves batch order;
    # callbacks (on_result / on_alignments) therefore fire on this
    # worker thread.  Queue depth = max_in_flight keeps the same
    # backpressure/memory bound as the old in-line drain.
    q_drain: "queue.Queue" = queue.Queue()
    drain_err: List[BaseException] = []
    # The in-flight budget (undrained batches alive at once) must stay
    # EXACTLY max_in_flight: each entry pins its batch's device buffers
    # (the fast4 dirs tensor is GBs at production shapes), and a looser
    # window OOMed HBM at 6+ batches.  The semaphore is acquired before
    # each dispatch and released only when the entry is fully drained --
    # the same bound the old drain-on-main-thread loop enforced, with
    # the drain still off the main thread.
    in_flight_sem = threading.Semaphore(depth)

    def drain_worker():
        while True:
            entry = q_drain.get()
            if entry is None:
                return
            try:
                if not drain_err:
                    _drain(entry)
            except BaseException as e:  # surface on the main thread
                drain_err.append(e)
            finally:
                del entry  # release the batch's device buffers
                in_flight_sem.release()

    threading.Thread(target=prep, daemon=True).start()
    threading.Thread(target=put, daemon=True).start()
    drain_t = threading.Thread(target=drain_worker, daemon=True)
    drain_t.start()

    def enqueue_drain(entry):
        q_drain.put(entry)
        if drain_err:
            raise drain_err[0]

    def _stream_loop():
        while True:
            item = q.get()
            kind = item[0]
            if kind == "done":
                break
            if kind == "error":
                raise item[1]
            # Block until an in-flight slot frees (see in_flight_sem).
            in_flight_sem.acquire()
            if kind == "args":
                _, i, args, plan, B, has_n, n_valid, batch_pairs = item
            else:
                _, i, batch, n_valid, batch_pairs = item
            if batch_pairs is None and cigars:
                raise ValueError(
                    "cigars=True requires byte pairs (the traceback needs "
                    "the raw sequences); stream (query, db) tuples instead "
                    "of PairBatch objects"
                )
            if cigars:
                from sequencealigning_tpu.ops.traceback_device import (
                    use_device_walk,
                )

                seqs1 = [p[0] for p in batch_pairs]
                seqs2 = [p[1] for p in batch_pairs]
                if _mp() and kind != "args":
                    raise NotImplementedError(
                        "multi-process cigars streaming requires the "
                        "stream-args route (kernel='stream')"
                    )
                if mode != "global":
                    # Textbook modes: fill + sharded device modes walk
                    # dispatched back-to-back (device route), or fill-only
                    # with dirs left on device for the host walkers.
                    # Multi-process always takes the device route (each
                    # process drains its addressable rows at finish, like
                    # the global fast4 path).
                    if kind != "args":
                        args, plan, B, has_n = runner._stream_args(batch)
                    n_best = B if _mp() else len(batch_pairs)
                    if use_device_walk(runner) or _mp():
                        best, xs, ys, handles, dirs, plan = (
                            runner.fill_walk_modes_from_stream_args(
                                args, plan, n_best, has_n, mode
                            )
                        )
                    else:
                        best, xs, ys, dirs, plan = (
                            runner.fill_modes_from_stream_args(
                                args, plan, n_best, has_n, mode
                            )
                        )
                        handles = None
                    extra = ("modes", handles, seqs1, seqs2, xs, ys, dirs,
                             plan)
                    n_slice = B if _mp() else len(batch_pairs)
                    enqueue_drain(
                        (i, best, n_slice, len(batch_pairs), extra)
                    )
                    continue
                if kind == "args" and (use_device_walk(runner) or _mp()):
                    # Fill + device walk dispatched back-to-back: the walk of
                    # this batch precedes the next batch's fill on the device
                    # queue, so its fetch/decode hide under that fill.
                    # Multi-process always takes this route: the device walk
                    # is sharded like the fill, and each process drains only
                    # its addressable packed-op rows at finish
                    # (runner._device_walk_finish_mp).
                    n_finals = B if _mp() else len(batch_pairs)
                    finals, handles = runner.fill_walk_from_stream_args(
                        args, plan, n_finals, has_n, seqs1, seqs2
                    )
                    extra = (handles, seqs1, seqs2)
                elif kind == "args":
                    finals, dirs, plan = runner.fill_with_dirs_from_stream_args(
                        args, plan, len(batch_pairs), has_n
                    )
                    extra = (dirs, plan, seqs1, seqs2)
                else:
                    finals, dirs, plan = runner.fill_with_dirs(batch)  # async
                    extra = (dirs, plan, seqs1, seqs2)
                # Multi-process: on_result sees the GLOBAL gathered finals
                # (like the scores-only path); on_alignments stays local.
                n_slice = B if (kind == "args" and _mp()) else len(batch_pairs)
                enqueue_drain(
                    (i, finals, n_slice, len(batch_pairs), extra)
                )
            else:
                if mode != "global":
                    if kind != "args":
                        args, plan, B, has_n = runner._stream_args(batch)
                    scores = runner.fill_modes_from_stream_args(
                        args, plan, B, has_n, mode, with_dirs=False
                    )[0]
                elif kind == "args":
                    scores = runner.scores_from_stream_args(args, plan, B, has_n)
                else:
                    scores = runner.scores(batch)  # async dispatch
                # Multi-process: on_result sees the GLOBAL gathered scores
                # (B covers every process's rows); n_pairs still counts only
                # this host's valid pairs.
                n_slice = B if (kind == "args" and _mp()) else n_valid
                enqueue_drain((i, scores, n_slice, n_valid, None))

    try:
        _stream_loop()
    finally:
        # Always release the drain worker (daemon, but a blocked
        # get() would leak one thread per aborted stream).
        q_drain.put(None)
        drain_t.join()
    if drain_err:
        raise drain_err[0]
    return n_done[0]


def _mp() -> bool:
    import jax

    return jax.process_count() > 1


def _chunks(pairs: Iterable[Tuple[bytes, bytes]], n: int):
    buf: List[Tuple[bytes, bytes]] = []
    for p in pairs:
        buf.append(p)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf
