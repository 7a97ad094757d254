"""On-device first-path traceback over the fast4 dirs layout.

The production fill emits 4 direction bits per DP cell (ops.dirbits
"fast4": H-argmax plane code + the two extend flags).  The host walkers
(ops.traceback.fast4_traceback_pair, the native C batch walker) need the
whole dirs tensor on the host first -- 0.5 byte/cell, ~8.6 GB at the
bench headline shape (4096 x 2 kb pairs), which makes device->host
transfer the dominant end-to-end alignment cost on any interconnect
(PERF.md "host fetches").

This module walks the traceback ON DEVICE instead: a lax.scan over walk
steps where every step gathers one dirs word per pair (XLA gather,
~14 ns/element) and updates the (x, y, plane) walk state with branchless
selects, emitting 2-bit op codes.  The packed op tensor fetched to the
host is 2 bits per WALK STEP (<= (l1+l2)/4 bytes/pair), a ~4000x
transfer reduction at 2 kb pairs: 8.6 GB -> ~4 MB.

Walk semantics are bit-identical to ops.traceback.fast4_traceback_pair
(same plane priority M > I > D, same boundary row/column chains, same
extend-bit rules); tests/test_traceback_device.py pins equality pairwise
on fuzzed batches.  The reference's co-optimal LIFO enumeration
(needleman_wunsch_affine.rs:281-329) stays a host concern on the 7-bit
"full" layout -- this walker returns ONE exact optimal alignment per
pair, the production contract.

The only data-dependent access per step is the dirs-word gather; the
M-plane case needs the NEXT cell's plane code, which the scalar walker
reads with a second lookup -- here the plane state instead goes to a
PENDING value that the following step resolves from its own (single)
gather, so every step costs exactly one gathered element per pair.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sequencealigning_tpu import backend as _backend

# Plane encoding inside the walk (matches the fast4 code values where
# applicable): 0 = M, 1 = I, 2 = D, 3 = PENDING (plane comes from the
# next step's gathered nibble -- only ever set after a diagonal move).
_PEND = 3

# Emitted 2-bit op codes (0 terminates; ops run end->start, reverse on
# the host).
_OP_NONE, _OP_M, _OP_I, _OP_D = 0, 1, 2, 3

_OP_LUT = np.frombuffer(b"\x00MID", dtype=np.uint8)


def _plane_step(nib, x, y, plane, std: bool = False):
    """One walk step given each pair's current-cell fast4 nibble:
    (op code, x', y', plane').  Bit-exact vectorization of the host
    walkers' shared loop body (ops.traceback.fast4_traceback_pair /
    _banded_fast4_walk).

    std=True walks the STANDARD gap-affine model (gaps open from
    H = max(M, I, D), ops.nw_banded_diag model='std'): a gap OPEN lands
    on the predecessor cell's best plane, so the plane goes to PENDING
    and resolves from the next step's own gather (the same trick the
    M-plane move already uses) instead of jumping to M."""
    # Resolve a pending plane from this cell's H-argmax code (clamp
    # code 3 to D exactly like the host walkers).
    plane = jnp.where(plane == _PEND, jnp.minimum(nib & 3, 2), plane)
    at_x0 = x == 0
    at_y0 = y == 0
    done = at_x0 & at_y0
    # Boundary chains first (host walker order): x == 0 forces I
    # (consume seq1), then y == 0 forces D (consume seq2).
    eff = jnp.where(at_x0, 1, jnp.where(at_y0, 2, plane))
    op = jnp.where(done, _OP_NONE, eff + 1).astype(jnp.uint8)
    step_x = (~done) & ((eff == 0) | (eff == 2))
    step_y = (~done) & ((eff == 0) | (eff == 1))
    open_to = _PEND if std else 0
    nxt = jnp.where(
        eff == 0,
        _PEND,
        jnp.where(
            eff == 1,
            jnp.where((nib & 4) != 0, 1, open_to),
            jnp.where((nib & 8) != 0, 2, open_to),
        ),
    )
    plane = jnp.where(done, plane, nxt)
    x = x - step_x.astype(jnp.int32)
    y = y - step_y.astype(jnp.int32)
    return op, x, y, plane


def _pack_ops(ops, t_steps: int):
    """(T, B) uint8 op codes -> (B, ceil(T/16)) uint32, 2 bits per step,
    little-endian in step."""
    t16 = -(-t_steps // 16)
    ops = jnp.pad(ops.astype(jnp.uint32), ((0, t16 * 16 - t_steps), (0, 0)))
    shift = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :, None]
    return (
        (ops.reshape(t16, 16, -1) << shift).sum(axis=1, dtype=jnp.uint32)
    ).transpose(1, 0)


# Walk steps per early-exit check.  t_steps must cover the all-indel
# worst case (l1 + l2), but a high-identity walk finishes in ~max(n1, n2)
# steps -- checking an all-pairs-done flag every _CHUNK steps cuts the
# gather traffic nearly in half on the production distribution.
_CHUNK = 512


def _chunked_walk(step_fn, carry0, done_fn, b: int, t_steps: int,
                  unroll: int):
    """Run step_fn (carry -> (carry, (B,) uint8 op)) for up to t_steps
    steps as _CHUNK-step scans under a while_loop that exits once
    done_fn(carry) holds for every pair.  Returns (carry, packed
    (B, ceil(t_steps/_CHUNK)*_CHUNK/16) uint32 codes, n_chunks_used);
    the tail beyond the exit stays zero, which the decoders treat as
    valid padding -- single-device callers fetch only the used prefix
    (packed[:, :n_chunks_used * _CHUNK // 16])."""
    n_chunks = -(-t_steps // _CHUNK)
    wpc = _CHUNK // 16
    packed0 = jnp.zeros((b, n_chunks * wpc), jnp.uint32)

    def cond(state):
        i, carry, _ = state
        return (i < n_chunks) & jnp.any(~done_fn(carry))

    def body(state):
        i, carry, packed = state
        carry, ops = lax.scan(
            lambda c, _: step_fn(c), carry, None, length=_CHUNK,
            unroll=unroll,
        )
        packed = lax.dynamic_update_slice(
            packed, _pack_ops(ops, _CHUNK), (0, i * wpc)
        )
        return i + 1, carry, packed

    n_used, carry, packed = lax.while_loop(
        cond, body, (jnp.int32(0), carry0, packed0)
    )
    return carry, packed, n_used


def _walk_fast4_impl(
    dirs, x0, y0, plane0, rowp, off, t_steps: int, unroll: int = 8
):
    """Batched fast4 walk over the stream layout (unjitted body, also
    used per shard under jax.shard_map by the data-parallel runner).
    dirs: (W, R, P) uint32 (8 nibbles per word, nibble d & 7 of word
    d >> 3 at [d >> 3, row, x]); x0/y0/plane0/rowp/off: (B,) int32 seeds.
    Returns ((x, y) final, packed (B, ceil(T/16)) uint32 op codes, 2 bits
    per step in walk order)."""

    def step(carry):
        x, y, plane = carry
        d = x + y + off
        w = dirs[d >> 3, rowp, x]  # one gathered element per pair
        nib = ((w >> ((d & 7).astype(jnp.uint32) * 4)) & 0xF).astype(
            jnp.int32
        )
        op, x, y, plane = _plane_step(nib, x, y, plane)
        return (x, y, plane), op

    (x, y, _), packed, n_used = _chunked_walk(
        step, (x0, y0, plane0), lambda c: (c[0] == 0) & (c[1] == 0),
        x0.shape[0], t_steps, unroll,
    )
    return (x, y), packed, n_used


_walk_fast4 = jax.jit(
    _walk_fast4_impl, static_argnames=("t_steps", "unroll")
)


@functools.partial(
    jax.jit, static_argnames=("t_steps", "unroll", "std", "substeps")
)
def _walk_banded_diag_msub(
    dirs, x0, y0, plane0, bidx, k_lo_even, t_steps: int, unroll: int = 2,
    std: bool = False, substeps: int = 4,
):
    """Multi-op-per-gather banded-diag walk: in this layout an M move
    keeps the LANE (diagonal) and decrements the wavefront index by 2,
    so the gathered word -- 8 consecutive wavefront nibbles of one lane
    -- covers up to `substeps` consecutive M ops.  Each scan step
    gathers ONCE and then consumes up to `substeps` ops while the
    position stays inside that word (same lane, same a >> 3); sub-steps
    that leave the word FREEZE (emit op 0, state unchanged) and the next
    scan step re-gathers.  The walk is scan-step LATENCY bound (~60 us
    per step at B=1024 regardless of batch width, PERF.md), so
    high-identity pairs -- long M runs -- walk up to `substeps`x fewer
    steps.  The emitted stream interleaves zeros for frozen sub-steps;
    a device-side stable sort (is-zero key -- order-preserving, no
    gathers) compacts them out before the repack, so callers receive a
    dense front run exactly like the single-step walkers'.

    COMPILE LIMIT (measured 2026-08-20; the same CPU-backend compiler
    fragility documented in docs/xla_cpu_segfault.md): the XLA:CPU
    backend's compile time explodes with inlined plane-steps per scan
    body -- single-device CPU handles 8 (1.2 s) but hangs at 12, and
    the 8-virtual-device test env hangs at 4 (2 compiles in 1.0 s).
    Callers pick (substeps, unroll) per platform through
    sequencealigning_tpu.backend.banded_walk_setting."""
    W, _, L = dirs.shape

    def step(carry):
        x, y, plane = carry
        a = x + y - 1
        l = (y - x - k_lo_even) >> 1
        valid = (l >= 0) & (l < L) & (a >= 0) & ((a >> 3) < W)
        w = dirs[
            jnp.clip(a >> 3, 0, W - 1), bidx, jnp.clip(l, 0, L - 1)
        ]
        base = a >> 3
        l0 = l
        ops = []
        for i in range(substeps):
            a_i = x + y - 1
            l_i = (y - x - k_lo_even) >> 1
            ok = valid & (a_i >= 0) & ((a_i >> 3) == base) & (l_i == l0)
            if i == 0:
                # First sub-step: the gather was made for this exact
                # position; only the band-validity mask applies.
                ok = valid
            nib = (
                (w >> ((a_i & 7).astype(jnp.uint32) * 4)) & 0xF
            ).astype(jnp.int32)
            nib = jnp.where(ok, nib, 0)
            # Boundary chains (x == 0 / y == 0) read no nibble; let them
            # advance on any sub-step.
            at_bnd = (x == 0) | (y == 0)
            run = ok | at_bnd
            op, x_n, y_n, p_n = _plane_step(nib, x, y, plane, std=std)
            x = jnp.where(run, x_n, x)
            y = jnp.where(run, y_n, y)
            plane = jnp.where(run, p_n, plane)
            ops.append(jnp.where(run, op, jnp.uint8(0)))
        return (x, y, plane), jnp.stack(ops, axis=0)

    n_chunks = -(-t_steps // _CHUNK)
    wpc = (_CHUNK * substeps) // 16
    b = x0.shape[0]
    packed0 = jnp.zeros((b, n_chunks * wpc), jnp.uint32)

    def cond(state):
        i, carry, _ = state
        return (i < n_chunks) & jnp.any(~((carry[0] == 0) & (carry[1] == 0)))

    def body(state):
        i, carry, packed = state
        carry, ops = lax.scan(
            lambda c, _: step(c), carry, None, length=_CHUNK,
            unroll=unroll,
        )
        ops = ops.reshape(_CHUNK * substeps, -1)
        packed = lax.dynamic_update_slice(
            packed, _pack_ops(ops, _CHUNK * substeps), (0, i * wpc)
        )
        return i + 1, carry, packed

    n_used, (x, y, _), packed = lax.while_loop(
        cond, body, (jnp.int32(0), (x0, y0, plane0), packed0)
    )
    # Device-side compaction: drop the interleaved zero ops (frozen
    # sub-steps) with ONE stable sort keyed on is-zero -- nonzeros keep
    # their relative (walk) order and move to the front, no gathers, no
    # host pass (the numpy compaction measured 270-870 ms at
    # 1024 x 6k ops on a 1-core host; the device sort is ~ms).  A walk
    # emits at most t_steps real ops, so only that prefix is repacked.
    shifts16 = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    ops_all = ((packed[:, :, None] >> shifts16) & 3).astype(jnp.uint8)
    ops_all = ops_all.reshape(b, -1)
    _, ops_c = lax.sort(
        ((ops_all == 0).astype(jnp.int32), ops_all),
        dimension=1, num_keys=1, is_stable=True,
    )
    w_out = max(-(-t_steps // 16), 1)
    ops_c = ops_c[:, : w_out * 16].astype(jnp.uint32)
    packed_c = (
        (ops_c.reshape(b, w_out, 16) << shifts16).sum(
            axis=2, dtype=jnp.uint32
        )
    )
    # n_used now counts 16-op words of the COMPACTED stream (max real
    # ops per pair, maxed over the batch so prefix fetches stay valid).
    n_ops = jnp.max(jnp.sum((ops_all != 0).astype(jnp.int32), axis=1))
    n_used_words = jnp.minimum((n_ops + 15) // 16 + 1, w_out)
    return (x, y), packed_c, n_used_words


def seed_planes(finals: np.ndarray) -> np.ndarray:
    """(B,) plane seeds from (B, 3) M/I/D corner finals, priority
    M > I > D (ops.traceback.fast4_traceback_pair's seed rule)."""
    finals = np.asarray(finals)
    score = finals.max(axis=1, keepdims=True)
    is_m = finals[:, 0:1] == score
    is_i = finals[:, 1:2] == score
    return np.where(is_m[:, 0], 0, np.where(is_i[:, 0], 1, 2)).astype(
        np.int32
    )


def decode_packed_ops(
    packed: np.ndarray, n1s: np.ndarray, n2s: np.ndarray
) -> List[Optional[str]]:
    """Packed (B, T16) uint32 walk codes -> forward op strings ('M'/'I'/
    'D', start->end).  A pair whose op count is not n1+n2 - #M (i.e. the
    walk did not consume exactly its sequences) decodes to None."""
    packed = np.asarray(packed)
    B, t16 = packed.shape
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(B, t16 * 16)
    chars = _OP_LUT[codes]  # (B, T) bytes, 0 = stop
    n_ops = (codes != 0).sum(axis=1)
    out: List[Optional[str]] = []
    for b in range(B):
        n = int(n_ops[b])
        ops_rev = chars[b, :n].tobytes()
        # Ops are emitted end->start; a valid walk consumes seq1 exactly
        # n1 times (M+I) and seq2 exactly n2 times (M+D).
        n_m = ops_rev.count(b"M")
        n_i = ops_rev.count(b"I")
        n_d = ops_rev.count(b"D")
        if n_m + n_i != int(n1s[b]) or n_m + n_d != int(n2s[b]):
            out.append(None)
            continue
        out.append(ops_rev[::-1].decode("ascii"))
    return out


RLE_CAP = 192  # runs/pair kept on device (production walks: ~2 runs/edit)


def rle_pack_ops(packed, cap: int = RLE_CAP):
    """Run-length encode the packed 2-bit op stream ON DEVICE.

    A production walk is long M-runs separated by single edits (~40 runs
    at 1% divergence), so its RLE is ~100x smaller than the 2-bit
    stream -- and the drain's dominant D2H on a slow link is exactly
    that stream.  packed: (B, W) uint32 (16 ops/word, little-endian).
    Returns (vals (B, cap) uint8, lens (B, cap) uint16, n_runs (B,)
    int32).  Pairs with n_runs > cap must fall back to fetching their
    full packed row (the tail runs are dropped here); lens are exact for
    T < 65536 (callers gate on the padded step count).

    Formulation: run boundaries are compacted with lax.top_k (the cap
    smallest boundary positions per row), then ONE cap-element gather
    per pair reads the run values (a scatter over the full (B, T)
    matrix gives identical outputs but touches every step).
    """
    B, W = packed.shape
    T = W * 16
    shift = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    ops = ((packed[:, :, None] >> shift) & 3).reshape(B, T).astype(jnp.uint8)
    bnd = jnp.concatenate(
        [jnp.ones((B, 1), bool), ops[:, 1:] != ops[:, :-1]], axis=1
    )
    n_runs = jnp.sum(bnd, axis=1).astype(jnp.int32)
    tv = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    keyed = jnp.where(bnd, tv, T)
    # top_k returns descending values of -keyed, i.e. ascending keyed:
    # the first cap run-start positions in walk order, padded with T.
    neg_starts, _ = jax.lax.top_k(-keyed, cap)
    starts = -neg_starts  # (B, cap) ascending, pad = T
    rows = jnp.arange(B)[:, None]
    vals = jnp.where(
        starts < T, ops[rows, jnp.minimum(starts, T - 1)], 0
    ).astype(jnp.uint8)
    ends = jnp.concatenate(
        [starts[:, 1:], jnp.full((B, 1), T, jnp.int32)], axis=1
    )
    lens = jnp.clip(ends - starts, 0, T).astype(jnp.uint16)
    return vals, lens, n_runs


def rle_expand_packed(vals, lens, W: int) -> np.ndarray:
    """Host inverse of rle_pack_ops: (B, R) run values/lengths -> the
    (B, W) uint32 packed word format the decoders consume.  One
    vectorized np.repeat + shift-sum pass (~10 ms at 2048 x 4096)."""
    B = vals.shape[0]
    T = W * 16
    lens = lens.astype(np.int64)
    tot = lens.sum(axis=1)
    # Trailing steps beyond the encoded runs are op 0 (the walkers' pad).
    pad = (T - tot).clip(0)
    flat_vals = np.concatenate(
        [vals.astype(np.uint8), np.zeros((B, 1), np.uint8)], axis=1
    ).reshape(-1)
    flat_lens = np.concatenate(
        [lens, pad[:, None]], axis=1
    ).reshape(-1)
    ops = np.repeat(flat_vals, flat_lens).reshape(B, T).astype(np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    return (ops.reshape(B, W, 16) << shifts).sum(
        axis=2, dtype=np.uint32
    )


def decode_packed_alignments(
    packed: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
) -> List[Optional[Tuple[str, str]]]:
    """Packed walk codes -> aligned (seq1, seq2) string pairs.  Routes to
    the threaded native decoder (native.walk_decode_batch_native) when the
    C runtime is available, else one vectorized NumPy pass over the (B, T)
    code matrix (the per-pair _apply_ops walk costs ~0.3 ms/pair at 2 kb,
    ~6x the NumPy pass, ~40x the native decode).  A pair whose walk did
    not consume exactly its sequences decodes to None (caller falls
    back)."""
    import os

    packed = np.asarray(packed)
    B, t16 = packed.shape
    T = t16 * 16
    n1s = np.asarray([len(s) for s in seqs1], np.int32)
    n2s = np.asarray([len(s) for s in seqs2], np.int32)
    l1 = max(1, int(n1s.max()) if B else 1)
    l2 = max(1, int(n2s.max()) if B else 1)
    s1p = np.zeros((B, l1), np.uint8)
    s2p = np.zeros((B, l2), np.uint8)
    for b in range(B):
        s1p[b, : n1s[b]] = np.frombuffer(seqs1[b], np.uint8)
        s2p[b, : n2s[b]] = np.frombuffer(seqs2[b], np.uint8)
    if not os.environ.get("SEQALIGN_NO_NATIVE"):
        try:
            from sequencealigning_tpu import native

            out = native.walk_decode_batch_native(packed, s1p, s2p, n1s, n2s)
            if out is not None:
                return out
        except Exception:
            pass
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & 3).astype(np.uint8).reshape(
        B, T
    )
    live = codes != 0
    takes1 = (codes == _OP_M) | (codes == _OP_I)  # consumes seq1
    takes2 = (codes == _OP_M) | (codes == _OP_D)  # consumes seq2
    c1 = np.cumsum(takes1, axis=1, dtype=np.int32)
    c2 = np.cumsum(takes2, axis=1, dtype=np.int32)
    # Walk order is end->start: the t-th op consumes char n - (running
    # count through t) of its sequence.
    rows = np.arange(B, dtype=np.intp)[:, None]
    gap = np.uint8(ord("-"))
    a1 = np.where(
        takes1, s1p[rows, np.clip(n1s[:, None] - c1, 0, l1 - 1)], gap
    )
    a2 = np.where(
        takes2, s2p[rows, np.clip(n2s[:, None] - c2, 0, l2 - 1)], gap
    )
    # Vectorized validation: ops must be a contiguous front run that
    # consumes each sequence exactly (zeros strictly after the stop).
    n_ops = live.sum(axis=1, dtype=np.int32)
    has_zero = n_ops < T
    first_zero = np.argmax(~live, axis=1).astype(np.int32)
    contiguous = ~has_zero | (first_zero == n_ops)
    # A zero-op walk is valid exactly when there is nothing to consume
    # (modes walks over empty stop..end substrings).
    ok = (
        ((n_ops > 0) | ((n1s == 0) & (n2s == 0)))
        & contiguous
        & (c1[:, -1] == n1s)
        & (c2[:, -1] == n2s)
    )
    out: List[Optional[Tuple[str, str]]] = []
    for b in range(B):
        if not ok[b]:
            out.append(None)
            continue
        n = int(n_ops[b])
        out.append(
            (
                a1[b, :n][::-1].tobytes().decode("latin-1"),
                a2[b, :n][::-1].tobytes().decode("latin-1"),
            )
        )
    return out


def _stream_walk_fetch(dirs, finals, n1s, n2s, plan, unroll):
    """Shared walk setup + dispatch + fetch for the stream fast4 layout
    (the coordinate mapping lives here ONCE for both decoders): returns
    (packed op codes, per-pair ended-at-origin mask), both host-side."""
    B = len(n1s)
    bs = np.arange(B)
    rowp = (bs // plan.np_slots).astype(np.int32)
    off = ((bs % plan.np_slots) * plan.s).astype(np.int32)
    (xf, yf), packed, n_used = _walk_fast4(
        dirs,
        jnp.asarray(n2s),
        jnp.asarray(n1s),
        jnp.asarray(seed_planes(finals)),
        jnp.asarray(rowp),
        jnp.asarray(off),
        t_steps=int(plan.l1 + plan.l2),
        unroll=unroll,
    )
    # Fetch only the used prefix: the early exit leaves the tail all
    # zeros, and on a slow interconnect the packed fetch rivals the walk.
    wpc = _CHUNK // 16
    packed = packed[:, : max(int(n_used), 1) * wpc]
    packed, xf, yf = jax.device_get((packed, xf, yf))
    return packed, (xf == 0) & (yf == 0)


def fast4_stream_walk_device(
    dirs: jax.Array,
    finals: np.ndarray,
    n1s: np.ndarray,
    n2s: np.ndarray,
    plan,
    unroll: int = 8,
) -> Tuple[List[Optional[str]], np.ndarray]:
    """Device walk over an ops.nw_affine_stream fast4 dirs tensor
    ((t_total/8, n_rows, P) uint32, pair b = slot b % np_slots of row
    b // np_slots, diagonal offset slot*s).

    Returns (op strings start->end, one per pair -- None where the walk
    failed validation -- and the (B,) scores).  Only the packed 2-bit op
    tensor crosses the device boundary."""
    B = len(n1s)
    n1s = np.asarray(n1s, np.int32)
    n2s = np.asarray(n2s, np.int32)
    finals = np.asarray(finals)[:B]
    packed, ended = _stream_walk_fetch(dirs, finals, n1s, n2s, plan, unroll)
    ops = decode_packed_ops(packed, n1s, n2s)
    ops = [o if ended[b] else None for b, o in enumerate(ops)]
    return ops, finals.max(axis=1)


_BROKEN = 4  # modes walk: parent byte had no H-plane bit (invalid fill)


def _walk_modes_impl(
    dirs, x0, y0, rowp, off, local: bool, t_steps: int, unroll: int = 8
):
    """Batched semi-global/local walk over the FULL 7-bit byte layout
    (ops.dirbits: 4 bytes/word, byte d & 3 of word d >> 2 at
    [d >> 2, row, x]).  Starts at each pair's end cell with the plane
    resolved from that cell's H-argmax bits (priority M > I > D, exactly
    ops.traceback._walk_from); stops at a boundary (semi) or at an
    M-plane LSTART restart cell (local).  Returns ((x, y, state) finals,
    packed op codes); state 1 = stopped cleanly, 2 = broken parent bits
    or out-of-range (caller falls back to the host walker)."""
    W, R, Pl = dirs.shape

    def step(carry):
        x, y, plane, st = carry
        d = x + y + off
        w = dirs[
            jnp.clip(d >> 2, 0, W - 1), rowp, jnp.clip(x, 0, Pl - 1)
        ]
        byte = ((w >> ((d & 3).astype(jnp.uint32) * 8)) & 0xFF).astype(
            jnp.int32
        )
        resolved = jnp.where(
            (byte & 1) != 0,
            0,
            jnp.where((byte & 2) != 0, 1, jnp.where((byte & 4) != 0, 2, _BROKEN)),
        )
        plane = jnp.where(plane == _PEND, resolved, plane)
        if local:
            stop_now = (plane == 0) & ((byte & 128) != 0)  # LSTART
        else:
            stop_now = (x == 0) | (y == 0)
        broken = (plane == _BROKEN) | (x < 0) | (y < 0)
        # broken takes priority over stop_now: a boundary cell with no
        # H-plane bits must fall back to the host walker (which raises
        # 'broken parent bits'), not report a clean stop (ADVICE r3).
        st = jnp.where(
            st != 0, st, jnp.where(broken, 2, jnp.where(stop_now, 1, 0))
        )
        active = st == 0
        op = jnp.where(active, plane + 1, 0).astype(jnp.uint8)
        step_x = active & ((plane == 0) | (plane == 2))
        step_y = active & ((plane == 0) | (plane == 1))
        nxt = jnp.where(
            plane == 0,
            _PEND,
            jnp.where(
                plane == 1,
                jnp.where((byte & 8) != 0, 1, 0),    # IEXT
                jnp.where((byte & 32) != 0, 2, 0),   # DEXT
            ),
        )
        plane = jnp.where(active, nxt, plane)
        x = x - step_x.astype(jnp.int32)
        y = y - step_y.astype(jnp.int32)
        return (x, y, plane, st), op

    pend = jnp.full_like(x0, _PEND)
    st0 = jnp.zeros_like(x0)
    (x, y, _, st), packed, n_used = _chunked_walk(
        step, (x0, y0, pend, st0), lambda c: c[3] != 0,
        x0.shape[0], t_steps, unroll,
    )
    # A walk still running after t_steps (possible only on a corrupt
    # local fill with no LSTART on the path) is invalid.
    st = jnp.where(st == 0, 2, st)
    return (x, y, st), packed, n_used


_walk_modes = jax.jit(
    _walk_modes_impl, static_argnames=("local", "t_steps", "unroll")
)


def modes_walk_device(
    dirs: jax.Array,
    end_x: np.ndarray,
    end_y: np.ndarray,
    rowp: np.ndarray,
    off: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    local: bool,
    t_steps: int,
    unroll: int = 8,
):
    """Device walk for the textbook modes (full-byte dirs layout, plain
    (D4, B, P) with rowp=b/off=0 or streamed (T4, R, P) with the plan's
    row/offset).  Returns a list, per pair, of
    (mid_aligned1, mid_aligned2, stop_x, stop_y) -- the walked segment
    between the stop cell and the end cell, exactly
    ops.traceback._walk_from's output -- or None where the device walk
    failed validation (caller falls back to the host walker)."""
    B = len(seqs1)
    end_x = np.asarray(end_x, np.int32)
    end_y = np.asarray(end_y, np.int32)
    (xf, yf, st), packed, n_used = _walk_modes(
        dirs,
        jnp.asarray(end_x),
        jnp.asarray(end_y),
        jnp.asarray(np.asarray(rowp, np.int32)),
        jnp.asarray(np.asarray(off, np.int32)),
        local=local,
        t_steps=t_steps,
        unroll=unroll,
    )
    packed = packed[:, : max(int(n_used), 1) * (_CHUNK // 16)]
    packed, xf, yf, st = jax.device_get((packed, xf, yf, st))
    return decode_modes_walk(
        packed, xf, yf, st, end_x, end_y, seqs1, seqs2
    )


def decode_modes_walk(packed, xf, yf, st, end_x, end_y, seqs1, seqs2):
    """Host tail shared by the single-device and sharded modes walks:
    decode against the walked substrings (ops consume exactly
    seq1[stop_y:end_y] / seq2[stop_x:end_x]) and return per pair
    (mid1, mid2, stop_x, stop_y) or None on validation failure."""
    B = len(seqs1)
    subs1 = [
        seqs1[b][int(yf[b]) : int(end_y[b])] for b in range(B)
    ]
    subs2 = [
        seqs2[b][int(xf[b]) : int(end_x[b])] for b in range(B)
    ]
    alns = decode_packed_alignments(packed, subs1, subs2)
    out = []
    for b in range(B):
        if st[b] != 1 or alns[b] is None:
            out.append(None)
            continue
        out.append((alns[b][0], alns[b][1], int(xf[b]), int(yf[b])))
    return out


def assemble_modes_alignments(
    pairs, walked, scores, end_x, end_y, local: bool, dirs_fetch,
):
    """Shared tail of every textbook-modes alignment path (model layer
    and the streaming pipeline): turn the device walk's per-pair
    (mid1, mid2, stop_x, stop_y) segments -- or host-walk fallbacks where
    the device walk returned None -- into full aligned strings.

    semi: free end gaps are assembled around the walked segment exactly
    as ops.traceback.semi_global_traceback_pair lays them out; local: the
    walked segment IS the alignment.  ``dirs_fetch(b) -> (dirs_b, d_off)``
    supplies one pair's dirs row for the host fallback walkers.
    ``walked`` may be None (pure host route: every pair falls back).

    Returns traceback_stream_batch-shaped results: per pair
    (score, [(aligned1, aligned2)]) or an AlignmentError instance."""
    from sequencealigning_tpu.errors import AlignerError
    from sequencealigning_tpu.ops.traceback import (
        local_affine_traceback_pair,
        semi_global_traceback_pair,
    )

    out = []
    for b, (s1, s2) in enumerate(pairs):
        if not s1 or not s2:
            # Degenerate pair: SW score of an empty sequence is 0; semi
            # end gaps are free (the masked fill never updates a
            # candidate cell here and would return sentinels).
            if local:
                out.append((0, [("", "")]))
            else:
                out.append((0, [(
                    s1.decode("latin-1") + "-" * len(s2),
                    "-" * len(s1) + s2.decode("latin-1"),
                )]))
            continue
        try:
            score = int(scores[b])
            x, y = int(end_x[b]), int(end_y[b])
            w = walked[b] if walked is not None else None
            if w is not None:
                mid1, mid2, sx, sy = w
                if local:
                    a1, a2 = mid1, mid2
                else:
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
                dirs_b, d_off = dirs_fetch(b)
                a1, a2, _sy, _sx = local_affine_traceback_pair(
                    dirs_b, x, y, s1, s2, d_offset=d_off
                )
            else:
                dirs_b, d_off = dirs_fetch(b)
                a1, a2 = semi_global_traceback_pair(
                    dirs_b, x, y, s1, s2, d_offset=d_off
                )
            out.append((score, [(a1, a2)]))
        except AlignerError as e:
            out.append(e)
    return out


def use_device_walk(config) -> bool:
    """Shared fast4-traceback routing (config.traceback): walk on device
    -- fetching 2-bit op codes instead of the dirs tensor -- when "auto"
    and the fill ran on an accelerator; "device"/"host" force."""
    choice = getattr(config, "traceback", "auto")
    if choice == "device":
        return True
    if choice == "host":
        return False
    # On an accelerator the walk is plain XLA gather/scan, and the dirs
    # fetch it replaces is the expensive side.
    return _backend.platform() != "cpu"


def banded_diag_device_tbs(
    dirs: jax.Array,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    k_lo_even: int,
    compat: bool = True,
    pair_idx: Optional[np.ndarray] = None,
    std: bool = False,
):
    """Device walk over a banded-diag fast4 fill in the host batch
    walkers' result format: a list of (score, [(a1, a2)]) /
    AlignmentError per pair.  A pair whose device walk fails validation
    falls back to fetching its single dirs slice and host-walking
    (ops.traceback.banded_diag_fast4_traceback_pair)."""
    from sequencealigning_tpu.errors import AlignmentError
    from sequencealigning_tpu.ops.traceback import (
        banded_diag_fast4_traceback_pair,
    )

    if pair_idx is None:
        pair_idx = np.arange(len(seqs1), dtype=np.int32)
    alns, scores = banded_diag_align_device(
        dirs, finals, seqs1, seqs2, k_lo_even, pair_idx=pair_idx, std=std
    )
    finals = np.asarray(finals)
    out = []
    for b in range(len(seqs1)):
        if alns[b] is None:
            slot = int(pair_idx[b])
            try:
                out.append(
                    banded_diag_fast4_traceback_pair(
                        np.asarray(dirs[:, slot, :]), finals[slot],
                        seqs1[b], seqs2[b], k_lo_even, compat=compat,
                        std=std,
                    )
                )
            except AlignmentError as e:
                out.append(e)
            continue
        out.append((int(scores[b]), [alns[b]]))
    return out


def banded_diag_align_device(
    dirs: jax.Array,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    k_lo_even: int,
    unroll: int = 8,
    pair_idx: Optional[np.ndarray] = None,
    std: bool = False,
    walk_setting: Optional[Tuple[int, int]] = None,
) -> Tuple[List[Optional[Tuple[str, str]]], np.ndarray]:
    """Device walk over an ops.nw_banded_diag fast4 dirs tensor
    ((Aw, B, L) uint32 wavefront-packed).  Returns (alignments, scores);
    None where the walk failed validation (e.g. the optimum escaped the
    band -- same signal the host walker's rescoring gate gives).
    pair_idx: dirs batch slot per sequence (default 0..B-1); pass a
    subset to walk only some slots (the band-doubling long-pair route).
    walk_setting: (substeps, unroll) of the walk, default the platform's
    (backend.banded_walk_setting)."""
    B = len(seqs1)
    n1s = np.asarray([len(s) for s in seqs1], np.int32)
    n2s = np.asarray([len(s) for s in seqs2], np.int32)
    if pair_idx is None:
        pair_idx = np.arange(B, dtype=np.int32)
    finals = np.asarray(finals)[np.asarray(pair_idx)]
    t_steps = int((n1s + n2s).max()) if B else 1
    # Multi-op-per-gather walk: the scan is per-step LATENCY bound, and
    # in this layout consecutive M ops share the gathered word, so
    # consuming up to 4 ops per gather shortens the walk on
    # high-identity pairs.  The emitted stream interleaves zeros for
    # frozen sub-steps; compact before decoding.  The (substeps, unroll)
    # choice is per platform (backend.banded_walk_setting; the CPU's
    # smaller factor still exercises the same freeze/compaction
    # mechanism in tests).
    substeps, msub_unroll = walk_setting or _backend.banded_walk_setting()
    (xf, yf), packed, n_used = _walk_banded_diag_msub(
        dirs,
        jnp.asarray(n2s),
        jnp.asarray(n1s),
        jnp.asarray(seed_planes(finals)),
        jnp.asarray(np.asarray(pair_idx, np.int32)),
        jnp.int32(k_lo_even),
        t_steps=t_steps,
        std=std,
        substeps=substeps,
        unroll=msub_unroll,
    )
    # The msub walker returns the stream already device-compacted;
    # n_used counts 16-op words of the compacted stream.
    packed = packed[:, : max(int(n_used), 1)]
    packed, xf, yf = jax.device_get((packed, xf, yf))
    alns = decode_packed_alignments(packed, seqs1, seqs2)
    ended = (xf == 0) & (yf == 0)
    alns = [a if ended[b] else None for b, a in enumerate(alns)]
    return alns, finals.max(axis=1)


def fast4_stream_align_device(
    dirs: jax.Array,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    plan,
    unroll: int = 8,
) -> Tuple[List[Optional[Tuple[str, str]]], np.ndarray]:
    """fast4_stream_walk_device + decode straight to aligned string
    pairs (native C decoder when available).  Returns (alignments, (B,)
    scores); a None alignment means the walk failed validation (caller
    falls back per pair)."""
    B = len(seqs1)
    n1s = np.asarray([len(s) for s in seqs1], np.int32)
    n2s = np.asarray([len(s) for s in seqs2], np.int32)
    finals = np.asarray(finals)[:B]
    packed, ended = _stream_walk_fetch(dirs, finals, n1s, n2s, plan, unroll)
    alns = decode_packed_alignments(packed, seqs1, seqs2)
    alns = [a if ended[b] else None for b, a in enumerate(alns)]
    return alns, finals.max(axis=1)
