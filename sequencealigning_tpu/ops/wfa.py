"""Batched wavefront alignment (WFA, gap-affine) on a device -- textbook mode.

Batched re-design of the reference's WFA (src/wfa.rs): instead of
score-indexed Vec<Option<...>> wavefronts with dynamic lo/hi bands, the
wavefronts are fixed-shape (B, K) offset vectors over a static diagonal band
k in [k_lo, k_hi] (absent diagonals = -inf mask), the greedy match-extension
is a precomputed run-length-table lookup (all diagonals of all pairs extend
simultaneously), and the score loop runs in fixed-size CHUNKS:

  * on-device fill state is a RING of the last max(o+e, e, x) + 1
    wavefronts per plane -- O(B * K), independent of the final score -- so
    the fill itself has no score ceiling (round-1 kept full (s_max, B, K)
    histories x3, making s_max a memory-bound divergence ceiling);
  * each chunk additionally emits its (S_CHUNK, B, K) int16 offset history
    (the compact traceback log -- offsets fit i16 for pairs <= 32 kb);
    the host accumulates chunks and the adaptive Python loop stops as soon
    as every live pair converged, so the `s_max` argument is only a
    safety cap, not an allocation size.

Coordinates (clean convention, unlike the reference's min(x,y) offsets --
see ops.oracle_wfa's module docstring for why the reference's own convention
is geometrically inconsistent): diag k = y - x, offset t = x (db chars
consumed), y = t + k.  Recurrence (Marco-Sola et al. 2021):

    I[s][k] = max(M[s-o-e][k-1], I[s-e][k-1])        (consume seq1)
    D[s][k] = max(M[s-o-e][k+1], D[s-e][k+1]) + 1    (consume seq2)
    M[s][k] = extend(max(M[s-x][k] + 1, I[s][k], D[s][k]))

Converged when M[s][k_target = n1-n2] == n2.  The static band plays the
role of the reference's adaptive trim (wfa.rs:490-623) as the pruning
device; band escapes are reported via the `converged` mask, and the model
layer retries escapees with a doubled band before the exact Gotoh fallback
(models.wfa).

The reference-compat WFA (bit-parity with the Rust, including its
convergence/trim/score quirks) lives in ops.oracle_wfa.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu.config import WfaPenalties
from sequencealigning_tpu.errors import AlignmentError

NEG = -(2 ** 14)  # fits int16; parked far below any offset
S_CHUNK = 256


def _score_stride(penalties: WfaPenalties) -> int:
    """Every reachable penalty is a non-negative integer combination of
    x, o+e and e, hence a multiple of their gcd.  Stepping the score loop
    by that stride skips the provably-dead (all-NEG) wavefronts between
    lattice points -- with the reference's defaults (x=4, o=2, e=6,
    wfa.rs:17-21) that is every odd s, i.e. an exact 2x on the fill loop
    and the per-step extension gather, and half the offset-history log."""
    g = math.gcd(
        penalties.mismatch,
        math.gcd(penalties.gap_extend,
                 penalties.gap_open + penalties.gap_extend),
    )
    return max(1, g)


class WfaBatchResult:
    """score: (B,) int32 penalty (valid where converged); converged: (B,)
    bool; hist: (S_total, 3, B, K) int16 offsets (M, I, D) -- fetched from
    device lazily on first access, so score-only consumers never pay the
    history transfer.  Row j of hist holds score s = j * stride: every
    reachable penalty is a multiple of gcd(x, e, o+e) (scores are sums of
    those three), so the fill only steps the lattice and the log only
    records it."""

    def __init__(self, score, converged, hist_chunks, k_lo: int,
                 stride: int = 1, end_k=None,
                 spans: Tuple[int, int, int, int] = (0, 0, 0, 0)):
        self.score = score
        self.converged = converged
        self._chunks = hist_chunks
        self.k_lo = k_lo
        self.stride = stride
        # Ends-free metadata: spans = (lead1, lead2, trail1, trail2) free
        # end-skip bounds (all 0 = global), end_k = per-pair hit diagonal.
        self.end_k = end_k
        self.spans = spans

    @property
    def hist(self) -> np.ndarray:
        if self._chunks is not None:
            # The dispatch-ahead fill loop may have enqueued chunks past
            # every pair's convergence (their rows are all-NEG: the chunk
            # while_loop exits at 0 steps once the batch is done).  The
            # traceback only ever reads rows <= score/stride, so skip
            # fetching trailing chunks beyond the batch's deepest score.
            smax = int(np.max(self.score, initial=-1))
            rows_needed = smax // self.stride + 1 if smax >= 0 else None
            out, rows = [], 0
            for c in self._chunks:
                if rows_needed is not None and rows >= rows_needed:
                    break
                out.append(np.asarray(c))
                rows += out[-1].shape[0]
            self._hist = np.concatenate(out, axis=0)
            self._chunks = None
        return self._hist


def _build_runlen(seq1, seq2, n1v, n2v, k_lo: int, K: int):
    """runlen[b, k, t] = exact-match run length starting at offset t on
    diagonal k.  Replaces the reference's per-character while-loop
    (wfa.rs:127-139).

    Fully parallel over t: runlen[t] = nextmiss[t] - t, where nextmiss is
    the reverse cumulative-min of (t where chars mismatch, else T) -- a
    log-depth associative_scan over the db axis instead of a T-step
    sequential lax.scan (the scan was ~20 us/step of dispatch, >60% of a
    128 x 10 kb batch).  The per-diagonal char windows are K *static*
    shifted slices of seq1 (no gathers).  int16 throughout (offsets are
    capped at 16 kb by wfa_textbook_batch)."""
    B = seq1.shape[0]
    T = seq2.shape[1]
    if T == 0:
        return jnp.zeros((B, K, 0), jnp.int16)
    pad_l = max(0, -k_lo)
    seq1_pad = jnp.pad(
        seq1, ((0, 0), (pad_l, max(0, K + T + k_lo - seq1.shape[1]))),
        constant_values=-1,
    ).astype(jnp.int16)
    s1win = jnp.stack(
        [
            jax.lax.slice_in_dim(seq1_pad, pad_l + k_lo + j,
                                 pad_l + k_lo + j + T, axis=1)
            for j in range(K)
        ],
        axis=1,
    )  # (B, K, T): s1win[b, j, t] = seq1[b, t + (k_lo + j)]
    tv = jax.lax.broadcasted_iota(jnp.int16, (B, K, T), 2)
    kv = jnp.int16(k_lo) + jax.lax.broadcasted_iota(jnp.int16, (B, K, T), 1)
    n1w = n1v.astype(jnp.int16)[:, :, None]
    n2w = n2v.astype(jnp.int16)[:, :, None]
    eq = jnp.logical_and(
        s1win == seq2.astype(jnp.int16)[:, None, :],
        jnp.logical_and(tv < n2w, (tv + kv) < n1w),
    )
    miss_at = jnp.where(eq, jnp.int16(T), tv)
    # Layout is load-bearing: the scan axis (T) must be MINOR-MOST.  With
    # K minor, materializing the scanned cube made XLA's buffer assignment
    # explode (a 40 GB peak at 128 x 10 kb on another accelerator's
    # compiler; the GPU's peak is recorded by chip_smoke.py's WFA phase),
    # and the lax.cummin ReduceWindow lowering hung the compiler in both
    # layouts.  The barrier keeps the K-slice window stack from being
    # fused into the scan's log-levels (the same explosion).
    miss_at = jax.lax.optimization_barrier(miss_at)
    nextmiss = jax.lax.associative_scan(
        jnp.minimum, miss_at, reverse=True, axis=2
    )
    return nextmiss - tv  # (B, K, T) int16, T on the lane dim


def _pack_input_host(query, db, qlen, dlen):
    """ONE fused device transfer for the batch's sequences AND lengths.

    Shipping two int32 (B, L) arrays costs host-to-device bandwidth, and
    each extra device_put pays the full link latency again.  The engine
    only ever tests CHAR EQUALITY, so any injective remap of the
    bytes that appear in the arrays preserves its results bit-for-bit:

      <= 4 distinct bytes (packed ACGT benches): 2-bit codes, 4 chars/byte
      <= 16 distinct bytes (DNA + IUPAC + pad):  4-bit codes, 2 chars/byte
      otherwise:                                  raw bytes

    Presence is found with one bincount over each array (np.unique's sort
    was ~54 ms on 2.6 MB; bincount is ~2 ms).  Both planes ride a single
    (2, B, W + 4) uint8 array whose last 4 columns carry the pair lengths
    (little-endian int32: plane 0 = qlen, plane 1 = dlen), decoded on
    device -- so the whole batch costs exactly one transfer latency.

    Returns (X uint8 (2, B, W + 4), bits in {2, 4, 8}, l1, l2).
    """
    qa = np.ascontiguousarray(query).astype(np.uint8, copy=False)
    da = np.ascontiguousarray(db).astype(np.uint8, copy=False)
    B = qa.shape[0]
    l1, l2 = qa.shape[1], da.shape[1]
    w = max(l1, l2)
    counts = np.bincount(qa.reshape(-1), minlength=256)
    counts += np.bincount(da.reshape(-1), minlength=256)
    uniq = np.flatnonzero(counts)
    bits = 2 if uniq.size <= 4 else (4 if uniq.size <= 16 else 8)
    if bits < 8:
        lut = np.zeros(256, np.uint8)
        lut[uniq] = np.arange(uniq.size, dtype=np.uint8)
        per = 8 // bits
        wp = -(-w // per) * per
        body = np.zeros((2, B, wp), np.uint8)
        body[0, :, :l1] = lut[qa]
        body[1, :, :l2] = lut[da]
        if bits == 2:
            body = (body[:, :, 0::4] | (body[:, :, 1::4] << 2)
                    | (body[:, :, 2::4] << 4) | (body[:, :, 3::4] << 6))
        else:
            body = body[:, :, 0::2] | (body[:, :, 1::2] << 4)
    else:
        body = np.zeros((2, B, w), np.uint8)
        body[0, :, :l1] = qa
        body[1, :, :l2] = da
    lens = np.empty((2, B, 4), np.uint8)
    lens[0] = (np.asarray(qlen).astype("<i4").reshape(B, 1)
               .view(np.uint8).reshape(B, 4))
    lens[1] = (np.asarray(dlen).astype("<i4").reshape(B, 1)
               .view(np.uint8).reshape(B, 4))
    return np.concatenate([body, lens], axis=2), bits, l1, l2


@functools.partial(
    jax.jit,
    static_argnames=("k_lo", "k_hi", "penalties", "bits", "l1", "l2"),
)
def _wfa_seed_jax(X, k_lo: int, k_hi: int,
                  penalties: WfaPenalties, bits: int, l1: int, l2: int):
    """Stage 1 of the seed: decode lengths, unpack chars, build the
    (B, K, T) run-length cube.  Kept as its OWN jit: when the cube and
    small arrays derived from its t=0 face are outputs of one program,
    XLA's layout assignment for the cube flips T off the minor dim and
    buffer assignment explodes (40 GB peak at 128 x 10 kb -- remote
    compile OOM).  Returning the cube alone pins the good layout; stage 2
    (_wfa_seed2_jax) consumes it as a materialized parameter."""
    B = X.shape[1]
    lb = X[:, :, -4:].astype(jnp.int32)  # little-endian int32 lengths
    lens = lb[..., 0] | (lb[..., 1] << 8) | (lb[..., 2] << 16) | (lb[..., 3] << 24)
    n1v = lens[0][:, None]
    n2v = lens[1][:, None]
    Xb = X[:, :, :-4]
    if bits == 2:
        both = jnp.stack(
            [(Xb >> j).astype(jnp.int16) & 3 for j in (0, 2, 4, 6)], axis=-1
        ).reshape(2, B, -1)
    elif bits == 4:
        both = jnp.stack(
            [(Xb & 0xF).astype(jnp.int16), (Xb >> 4).astype(jnp.int16)],
            axis=-1,
        ).reshape(2, B, -1)
    else:
        both = Xb.astype(jnp.int16)
    seq1 = both[0, :, :l1]
    seq2 = both[1, :, :l2]
    K = k_hi - k_lo + 1
    runlen = _build_runlen(seq1, seq2, n1v, n2v, k_lo, K)
    return runlen, n1v, n2v


def _end_targets(n1v, n2v, kv, spans):
    """Per-diagonal end offsets for (bounded) ends-free alignment.

    spans = (lead1, lead2, trail1, trail2): maximum FREE leading /
    trailing skips of seq1 / seq2 (WFA2-lib-style span bounds; all 0 =
    global).  An alignment may end at x = n2 with up to trail1 unconsumed
    seq1 chars (diagonals dtar-trail1 .. dtar, end offset n2), or at
    y = n1 with up to trail2 unconsumed seq2 chars (diagonals
    dtar .. dtar+trail2, end offset n1 - k).  Offsets cannot overshoot
    either target (both lie on the t <= n2 / y <= n1 feasibility
    boundary), so `offset >= end_t` detects exact arrival.

    Returns (end_t (B, K) int32, end_mask (B, K) bool)."""
    _l1, _l2, trail1, trail2 = spans
    dtar = n1v - n2v
    in_a = jnp.logical_and(kv >= dtar - trail1, kv <= dtar)
    in_b = jnp.logical_and(kv > dtar, kv <= dtar + trail2)
    end_t = jnp.where(in_a, n2v, jnp.where(in_b, n1v - kv, 2 ** 14))
    return end_t, jnp.logical_or(in_a, in_b)


@functools.partial(
    jax.jit, static_argnames=("k_lo", "k_hi", "penalties", "spans")
)
def _wfa_seed2_jax(runlen, n1v, n2v, k_lo: int, k_hi: int,
                   penalties: WfaPenalties,
                   spans: Tuple[int, int, int, int] = (0, 0, 0, 0)):
    """Stage 2 of the seed (s=0): leading match runs from the free-start
    window (global: just diagonal 0 at t=0) off the cube's seed face.
    Returns (rings preloaded with s=0, done0, score0, end_k0, seed
    history row)."""
    B, K, T = runlen.shape
    lead1, lead2, _t1, _t2 = spans
    kv = k_lo + jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)

    # Free-start seeds: skip up to lead1 seq1 chars (start (0, y0=k),
    # 0 <= k <= lead1) or up to lead2 seq2 chars (start (x0=-k, 0),
    # -lead2 <= k < 0); each seed extends its leading match run from
    # t0 = max(0, -k).
    t0v = jnp.maximum(0, -kv)
    seeded = jnp.logical_and(kv >= -lead2, kv <= lead1)
    seeded = jnp.logical_and(seeded, t0v <= n2v)
    seeded = jnp.logical_and(seeded, kv <= n1v)
    if T > 0:
        run0 = jnp.take_along_axis(
            runlen.astype(jnp.int32),
            jnp.clip(t0v, 0, T - 1)[:, :, None], axis=2,
        )[:, :, 0]
        run0 = jnp.where(t0v < T, run0, 0)
    else:
        run0 = jnp.zeros((B, K), jnp.int32)
    m0 = t0v + run0
    ok0 = jnp.logical_and(
        jnp.logical_and(m0 >= 0, m0 <= n2v),
        jnp.logical_and((m0 + kv) >= 0, (m0 + kv) <= n1v),
    )
    m0 = jnp.where(jnp.logical_and(seeded, ok0), m0, NEG)

    g = _score_stride(penalties)
    rl = max(penalties.gap_open + penalties.gap_extend,
             penalties.gap_extend, penalties.mismatch) // g + 1
    negs = jnp.full((rl, B, K), NEG, jnp.int32)
    ring_m = negs.at[0].set(m0)
    ring_i = negs
    ring_d = negs

    end_t, end_mask = _end_targets(n1v, n2v, kv, spans)
    hit0 = jnp.logical_and(m0 >= end_t, end_mask)
    done0 = jnp.any(hit0, axis=1)
    end_k0 = jnp.where(
        done0, k_lo + jnp.argmax(hit0, axis=1).astype(jnp.int32),
        (n1v - n2v)[:, 0],
    )
    score0 = jnp.where(done0, 0, -1).astype(jnp.int32)
    seed_row = jnp.stack(
        [m0, jnp.full((B, K), NEG, jnp.int32), jnp.full((B, K), NEG, jnp.int32)],
        axis=0,
    ).astype(jnp.int16)[None]  # (1, 3, B, K)
    return ring_m, ring_i, ring_d, done0, score0, end_k0, seed_row


@functools.partial(
    jax.jit, static_argnames=("k_lo", "k_hi", "penalties", "spans")
)
def _wfa_chunk_jax(
    runlen, ring_m, ring_i, ring_d, u0, done, score, end_k,
    n1v, n2v, k_lo: int, k_hi: int, penalties: WfaPenalties,
    spans: Tuple[int, int, int, int] = (0, 0, 0, 0),
):
    """Advance S_CHUNK lattice steps (scores s = (u0+i)*g for the score
    stride g -- see _score_stride).  Fill state is the rings (indexed in
    lattice units u = s/g); the chunk's per-step offsets are emitted as an
    (S_CHUNK, 3, B, K) int16 history block for host traceback, row i
    holding score (u0+i)*g."""
    B, K = ring_m.shape[1:]
    g = _score_stride(penalties)
    x_pen = penalties.mismatch // g
    e_pen = penalties.gap_extend // g
    oe = (penalties.gap_open + penalties.gap_extend) // g
    rl = ring_m.shape[0]
    kv = k_lo + jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)
    negs = jnp.full((B, K), NEG, jnp.int32)
    end_t, end_mask = _end_targets(n1v, n2v, kv, spans)
    T = runlen.shape[2]
    BIG = 2 ** 14  # parks absent lanes out of bounds so extend() skips them

    def ok(t):
        y = t + kv
        return jnp.logical_and(
            jnp.logical_and(t >= 0, t <= n2v),
            jnp.logical_and(y >= 0, y <= n1v),
        )

    def extend(t):
        if T == 0:
            return t
        idx = jnp.clip(t, 0, max(T - 1, 0))[:, :, None]  # (B, K, 1)
        run = jnp.take_along_axis(
            runlen, idx, axis=2)[:, :, 0].astype(jnp.int32)
        return t + jnp.where(jnp.logical_and(t >= 0, t < T), run, 0)

    def shift_left(a):  # lane k reads k+1
        return jnp.concatenate([a[:, 1:], jnp.full((B, 1), NEG, a.dtype)], 1)

    def shift_right(a):  # lane k reads k-1
        return jnp.concatenate([jnp.full((B, 1), NEG, a.dtype), a[:, :-1]], 1)

    def ring_at(ring, u_):
        row = jax.lax.dynamic_slice(
            ring, (jnp.maximum(u_, 0) % rl, 0, 0), (1, B, K)
        )[0]
        return jnp.where(u_ >= 0, row, negs)

    def body(carry):
        ring_m, ring_i, ring_d, done, score, end_k, hist, i = carry
        u = u0 + i  # lattice step; true score s = u * g
        m_oe = ring_at(ring_m, u - oe)
        m_x = ring_at(ring_m, u - x_pen)
        i_e = ring_at(ring_i, u - e_pen)
        d_e = ring_at(ring_d, u - e_pen)

        i_new = jnp.maximum(shift_right(m_oe), shift_right(i_e))
        i_new = jnp.where(jnp.logical_and(i_new > NEG, ok(i_new)), i_new, NEG)
        d_src = jnp.maximum(shift_left(m_oe), shift_left(d_e))
        d_new = jnp.where(d_src > NEG, d_src + 1, NEG)
        d_new = jnp.where(ok(d_new), d_new, NEG)
        m_cand = jnp.maximum(
            jnp.where(m_x > NEG, m_x + 1, NEG), jnp.maximum(i_new, d_new)
        )
        m_cand = jnp.where(ok(m_cand), m_cand, NEG)
        m_new = extend(jnp.where(m_cand > NEG, m_cand, BIG))
        m_new = jnp.where(m_cand > NEG, m_new, NEG)

        live = jnp.logical_not(done)[:, None]
        m_new = jnp.where(live, m_new, NEG)
        i_new = jnp.where(live, i_new, NEG)
        d_new = jnp.where(live, d_new, NEG)

        slot = u % rl
        ring_m = jax.lax.dynamic_update_slice(ring_m, m_new[None], (slot, 0, 0))
        ring_i = jax.lax.dynamic_update_slice(ring_i, i_new[None], (slot, 0, 0))
        ring_d = jax.lax.dynamic_update_slice(ring_d, d_new[None], (slot, 0, 0))

        hitk = jnp.logical_and(m_new >= end_t, end_mask)
        hit = jnp.any(hitk, axis=1)
        newly = jnp.logical_and(hit, jnp.logical_not(done))
        score = jnp.where(newly, u * g, score)
        end_k = jnp.where(
            newly, k_lo + jnp.argmax(hitk, axis=1).astype(jnp.int32), end_k
        )
        done = jnp.logical_or(done, hit)
        row = jnp.stack([m_new, i_new, d_new], axis=0).astype(jnp.int16)
        hist = jax.lax.dynamic_update_slice(
            hist, row[None], (i, 0, 0, 0)
        )
        return ring_m, ring_i, ring_d, done, score, end_k, hist, i + 1

    # while_loop, not scan: the chunk EXITS at convergence instead of
    # burning the remaining gather-bound steps (e.g. ~110 of 256 dead
    # steps at config 3's typical score).  Unwritten history rows stay
    # NEG; the traceback only reads rows <= each pair's own score.
    def cond(carry):
        done, i = carry[3], carry[7]
        return jnp.logical_and(i < S_CHUNK, jnp.logical_not(done.all()))

    hist0 = jnp.full((S_CHUNK, 3, B, K), jnp.int16(NEG))
    ring_m, ring_i, ring_d, done, score, end_k, rows, _ = jax.lax.while_loop(
        cond, body,
        (ring_m, ring_i, ring_d, done, score, end_k, hist0, jnp.int32(0)),
    )
    return ring_m, ring_i, ring_d, done, score, end_k, rows


def wfa_textbook_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    penalties: WfaPenalties = WfaPenalties(),
    band: int = 64,
    s_max: int = 16_384,
    spans: Tuple[int, int, int, int] = (0, 0, 0, 0),
) -> WfaBatchResult:
    """Batched exact gap-affine WFA.  band = half-width of the static
    diagonal window beyond the batch's length-difference range; s_max is a
    safety cap on the penalty score (fill memory is score-independent).

    spans = (lead1, lead2, trail1, trail2): WFA2-lib-style bounded
    ends-free alignment -- up to lead1/trail1 seq1 chars and lead2/trail2
    seq2 chars may be skipped FREE at the start/end (all 0 = global).
    Unbounded both-sides ends-free is degenerate under min-penalty
    scoring (the empty alignment costs 0 -- PARITY.md modes matrix row
    3); the span bounds are what make the problem well-posed, exactly as
    in WFA2-lib's ends-free mode."""
    qlen = np.asarray(query_len)
    dlen = np.asarray(db_len)
    spans = tuple(int(v) for v in spans)
    lead1, lead2, trail1, trail2 = spans
    if int(dlen.max(initial=0)) >= 2 ** 14 or int(qlen.max(initial=0)) >= 2 ** 14:
        raise AlignmentError(
            "textbook WFA int16 offset log caps pairs at 16 kb; use the "
            "Gotoh engines for longer pairs"
        )
    diff = qlen.astype(np.int64) - dlen.astype(np.int64)
    dmin = int(diff.min()) if diff.size else 0
    dmax = int(diff.max()) if diff.size else 0
    # The band must cover the free-start window [-lead2, lead1] and every
    # pair's free-end window [dtar - trail1, dtar + trail2].
    need_lo = min(0, dmin, -lead2, dmin - trail1)
    need_hi = max(0, dmax, lead1, dmax + trail2)
    k_lo = need_lo - band
    k_hi = need_hi + band
    # Lane-align K: the runlen cube and every chunk op put K on the minor
    # (lane) dim, so K = 129 (the default band's count) would pad to 256
    # -- half the vector width wasted.  Round K UP to
    # the next multiple of 128: never below the user-requested band (a
    # trimmed band could converge to a slightly suboptimal penalty with
    # no flag -- band escapes only surface as non-convergence), so the
    # lane alignment can only widen the search, keeping results at least
    # as good as the untrimmed call.
    K_need = need_hi - need_lo + 1
    K_cur = k_hi - k_lo + 1
    K_tgt = max(128, 128 * ((K_cur + 127) // 128),
                128 * ((K_need + 127) // 128))
    if K_tgt > K_cur:
        add = K_tgt - K_cur
        k_lo -= add // 2
        k_hi += add - add // 2

    X, bits, l1, l2 = _pack_input_host(query, db, qlen, dlen)
    runlen, n1v, n2v = _wfa_seed_jax(
        jnp.asarray(X), k_lo, k_hi, penalties, bits, l1, l2
    )
    ring_m, ring_i, ring_d, done, score, end_k, seed_row = _wfa_seed2_jax(
        runlen, n1v, n2v, k_lo, k_hi, penalties, spans
    )
    g = _score_stride(penalties)
    chunks = [seed_row]
    u = 1  # lattice step (score = u * g); seed covered u=0
    u_max = (s_max + g - 1) // g
    # Dispatch-AHEAD convergence protocol: enqueue a group of chunks, then
    # test the done flags of the PREVIOUS group while the new one executes
    # -- the host never stalls the device waiting for a (B,)-bool fetch.
    # Overshooting by one group is nearly free: each chunk's while_loop
    # exits after 0 steps once its whole batch is converged.
    prev_done = None
    while u < u_max:
        for _ in range(4):
            if u >= u_max:
                break
            (ring_m, ring_i, ring_d, done, score, end_k,
             rows) = _wfa_chunk_jax(
                runlen, ring_m, ring_i, ring_d, jnp.int32(u), done, score,
                end_k, n1v, n2v, k_lo, k_hi, penalties, spans,
            )
            chunks.append(rows)
            u += S_CHUNK
        if prev_done is not None and bool(np.asarray(prev_done).all()):
            break
        prev_done = done
    return WfaBatchResult(
        score=np.asarray(score), converged=np.asarray(done),
        hist_chunks=chunks, k_lo=k_lo, stride=g,
        end_k=np.asarray(end_k), spans=spans,
    )


def wfa_traceback_host(
    result: WfaBatchResult,
    b: int,
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties = WfaPenalties(),
) -> Tuple[int, str, str]:
    """Reconstruct one pair's alignment from the offset history log.

    Returns (penalty, aligned_seq1, aligned_seq2).  Tie priority:
    mismatch > I > D (deterministic, documented).
    """
    import os

    if not bool(np.asarray(result.converged)[b]):
        raise AlignmentError("WFA did not converge within band/s_max")
    s = int(np.asarray(result.score)[b])
    if result.spans == (0, 0, 0, 0) and not os.environ.get(
        "SEQALIGN_NO_NATIVE"
    ):
        # The native C walker implements the global start/stop contract;
        # ends-free tracebacks use the Python walker's seed window.
        try:
            from sequencealigning_tpu import native

            if native.available():
                r = native.wfa_textbook_traceback_native(
                    result.hist, b, result.k_lo, s, seq1, seq2, penalties,
                    stride=result.stride,
                )
                if r is not None:
                    return s, r[0], r[1]
        except Exception:
            pass  # fall through to the Python walker
    mid1, mid2, _k0, _t0 = _walk_hist(
        result, b, seq1, seq2, penalties, len(seq1) - len(seq2), len(seq2)
    )
    return s, mid1, mid2


def _walk_hist(
    result: WfaBatchResult,
    b: int,
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties,
    k_start: int,
    t_start: int,
) -> Tuple[str, str, int, int]:
    """Shared offset-history walker: reconstruct the aligned SEGMENT from
    (k_start, t_start) back to an s=0 seed.  Global tracebacks start at
    (n1-n2, n2) and stop on diagonal 0 at t=0; ends-free tracebacks start
    at the recorded hit diagonal and stop on any seed diagonal k0 in the
    free-start window at t0 = max(0, -k0).  Returns
    (aligned_seq1_segment, aligned_seq2_segment, k0, t0)."""
    s = int(np.asarray(result.score)[b])
    hist_b = np.asarray(result.hist[:, :, b, :], np.int32)  # (S, 3, K)
    m_hist, i_hist, d_hist = hist_b[:, 0], hist_b[:, 1], hist_b[:, 2]
    k_lo = result.k_lo
    g = result.stride  # hist row j holds score j * g
    n1, n2 = len(seq1), len(seq2)
    x_pen, o_pen, e_pen = penalties.mismatch, penalties.gap_open, penalties.gap_extend
    oe = o_pen + e_pen
    lead1, lead2 = result.spans[0], result.spans[1]

    def hist(h, s_, k_):
        lane = k_ - k_lo
        if s_ < 0 or s_ % g or lane < 0 or lane >= h.shape[1]:
            return NEG
        row = s_ // g
        if row >= h.shape[0]:
            return NEG
        return int(h[row, lane])

    a1: List[str] = []
    a2: List[str] = []
    state = "M"
    k = k_start
    t = t_start

    def emit_matches(n: int, t_end: int) -> None:
        # Matches ending at offset t_end (exclusive) on diagonal k.  The
        # whole walk is emitted back-to-front and reversed at the end, so
        # runs are appended last-column-first.
        for tt in range(t_end - 1, t_end - n - 1, -1):
            a1.append(chr(seq1[tt + k]))
            a2.append(chr(seq2[tt]))

    guard = 0
    while True:
        guard += 1
        if guard > 4 * (n1 + n2) + s + 16:
            raise AlignmentError("WFA traceback did not terminate")
        if state == "M":
            if s == 0:
                # initial seed: leading matches down to the seed offset
                # t0 = max(0, -k) on a free-start diagonal.
                if not (-lead2 <= k <= lead1):
                    raise AlignmentError(
                        "WFA traceback landed outside the seed window"
                    )
                t0 = max(0, -k)
                emit_matches(t - t0, t)
                break
            mx = hist(m_hist, s - x_pen, k)
            iv = hist(i_hist, s, k)
            dv = hist(d_hist, s, k)
            t_pre = max(mx + 1 if mx > NEG else NEG, iv, dv)
            emit_matches(t - t_pre, t)
            t = t_pre
            if mx > NEG and t_pre == mx + 1:
                # mismatch column
                a1.append(chr(seq1[t - 1 + k]))
                a2.append(chr(seq2[t - 1]))
                s, t = s - x_pen, t - 1
            elif t_pre == iv:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            # consume seq1[t + k - 1]; came from k-1 with same t
            a1.append(chr(seq1[t + k - 1]))
            a2.append("-")
            m_src = hist(m_hist, s - oe, k - 1)
            if m_src == t:
                s, k, state = s - oe, k - 1, "M"
            else:
                s, k = s - e_pen, k - 1
        else:  # D: consume seq2[t-1]; came from k+1 with t-1
            a1.append("-")
            a2.append(chr(seq2[t - 1]))
            m_src = hist(m_hist, s - oe, k + 1)
            if m_src == t - 1:
                s, k, t, state = s - oe, k + 1, t - 1, "M"
            else:
                s, k, t = s - e_pen, k + 1, t - 1

    return "".join(reversed(a1)), "".join(reversed(a2)), k, t0


_TB_CHUNK_T = 256  # device-walk step bucket (compile-cache granularity)


@functools.partial(
    jax.jit, static_argnames=("k_lo", "g", "T", "x_pen", "o_pen", "e_pen")
)
def _wfa_walk_device_jit(hist, s0, k0v, t0v, live0, k_lo: int, g: int,
                         T: int, x_pen: int, o_pen: int, e_pen: int):
    """Batched on-device walk of the offset-history log: a lax.scan whose
    every step gathers THREE history values per pair (the M/I/D reads of
    ops.wfa._walk_hist's loop body, branchlessly selected by state) and
    emits one RLE op run (val, len).  Bit-equal to the host walker: same
    tie priority (mismatch > I > D), same open-vs-extend probes.

    hist: (S, 3, B, K) int16 device log; s0/k0v/t0v (B,) int32 seeds;
    live0: converged mask.  Returns (vals (B, T) uint8 — 1=M 2=I 3=D,
    0 pad — lens (B, T) int32, ok (B,) bool: walk reached the s=0 seed
    on diagonal 0 within T steps)."""
    S, _three, B, K = hist.shape
    oe = o_pen + e_pen
    bidx = jnp.arange(B)
    NEGi = jnp.int32(NEG)

    def gat(plane, r, ln):
        ok = (
            (r >= 0) & (r % g == 0) & (r // g < S) & (ln >= 0) & (ln < K)
        )
        v = hist[
            jnp.clip(r // g, 0, S - 1), plane, bidx,
            jnp.clip(ln, 0, K - 1),
        ].astype(jnp.int32)
        return jnp.where(ok, v, NEGi)

    def step(carry, _):
        s, k, t, st, bad = carry
        lane = k - jnp.int32(k_lo)
        is_m = st == 0
        is_i = st == 1
        is_d = st == 2
        live = st < 3
        # Gather 1 reads the M plane at the state's probe row/lane:
        # M: (s - x, k); I: (s - o - e, k - 1); D: (s - o - e, k + 1).
        r1 = jnp.where(is_m, s - x_pen, s - oe)
        l1 = lane + jnp.where(is_m, 0, jnp.where(is_i, -1, 1))
        mx = gat(0, r1, l1)
        iv = gat(1, s, lane)
        dv = gat(2, s, lane)
        # --- M state: emit the match run, then mismatch / I / D / seed.
        mx1 = jnp.where(mx > NEGi, mx + 1, NEGi)
        t_pre = jnp.maximum(jnp.maximum(mx1, iv), dv)
        seed = is_m & (s == 0)
        mis = is_m & ~seed & (mx > NEGi) & (t_pre == mx1)
        toI = is_m & ~seed & ~mis & (t_pre == iv)
        run = t - t_pre
        # --- I/D states: open-vs-extend probe (gather 1 doubles as m_src).
        opn = jnp.where(is_i, mx == t, mx == t - 1)
        # Emitted RLE run for this step (walk order: end -> start).
        val = jnp.where(
            ~live, 0, jnp.where(is_m, 1, jnp.where(is_i, 2, 3))
        ).astype(jnp.uint8)
        ln_m = jnp.where(seed, t, jnp.where(mis, run + 1, run))
        ln = jnp.where(~live, 0, jnp.where(is_m, ln_m, 1))
        # Next state.
        s_n = jnp.where(
            is_m, jnp.where(mis, s - x_pen, s),
            jnp.where(opn, s - oe, s - e_pen),
        )
        k_n = k + jnp.where(is_i, -1, jnp.where(is_d, 1, 0))
        t_n = jnp.where(
            is_m,
            jnp.where(seed, 0, jnp.where(mis, t_pre - 1, t_pre)),
            jnp.where(is_d, t - 1, t),
        )
        st_n = jnp.where(
            is_m,
            jnp.where(seed, 3, jnp.where(mis, 0, jnp.where(toI, 1, 2))),
            jnp.where(opn, 0, st),
        )
        # A global seed must land on diagonal 0 (the host walker's
        # seed-window check); a negative run length means a corrupt log.
        bad = bad | (live & ((ln < 0) | (seed & (k != 0))))
        s, k, t, st = (
            jnp.where(live, v, o) for v, o in
            ((s_n, s), (k_n, k), (t_n, t), (st_n, st))
        )
        return (s, k, t, st, bad), (val, ln)

    st0 = jnp.where(live0, 0, 3).astype(jnp.int32)
    bad0 = jnp.zeros_like(live0)
    (sf, kf, tf, stf, bad), (vals, lens) = jax.lax.scan(
        step, (s0, k0v, t0v, st0, bad0), None, length=T, unroll=8
    )
    ok = live0 & (stf == 3) & ~bad
    return vals.T, lens.T, ok


def wfa_traceback_device(
    result: WfaBatchResult,
    seqs1: List[bytes],
    seqs2: List[bytes],
    penalties: WfaPenalties = WfaPenalties(),
) -> List[Optional[Tuple[str, str]]]:
    """Batched ON-DEVICE traceback from the offset-history log (global
    mode): the offset log never leaves the device (~(S, 3, B, K) int16,
    hundreds of MB at 128 x 10 kb), and the walk's sequential scalar
    chain runs as one lax.scan emitting RLE op runs -- 3 bytes/step to
    the host instead of the whole log.  The RLE stream feeds the same
    rle_expand_packed + decode_packed_alignments pipeline as the Gotoh
    device walks (native C decode, exact consumption validation).

    Returns one (aligned_seq1, aligned_seq2) per pair, or None where the
    pair did not converge, the walk failed validation, or the result is
    ends-free (spans walk stays on the host) -- callers fall back to
    wfa_traceback_host per pair.  Alignments are bit-identical to the
    host walker (same tie priority; pinned in tests/test_wfa_device_tb).
    """
    from sequencealigning_tpu.ops.traceback_device import (
        decode_packed_alignments,
        rle_expand_packed,
    )

    B = len(seqs1)
    if result.spans != (0, 0, 0, 0):
        return [None] * B
    conv = np.asarray(result.converged)[:B]
    if not conv.any():
        return [None] * B
    score = np.asarray(result.score)[:B]
    g = result.stride
    # Device-side history: the still-on-device chunks when available
    # (the normal path -- score-only fetches never happened), else the
    # host copy shipped back once.
    chunks = result._chunks
    if chunks is not None:
        smax = int(score.max(initial=-1))
        rows_needed = smax // g + 1 if smax >= 0 else 1
        keep, rows = [], 0
        for c in chunks:
            if rows >= rows_needed:
                break
            keep.append(c)
            rows += c.shape[0]
        hist = jnp.concatenate(keep, axis=0) if len(keep) > 1 else keep[0]
    else:
        hist = jnp.asarray(result.hist)
    n1s = np.array([len(x) for x in seqs1], np.int64)
    n2s = np.array([len(x) for x in seqs2], np.int64)
    pen = penalties
    # Step budget: every 2 walk steps retire at least min(x, e) penalty
    # (M-state transitions to I/D spend no penalty; the I/D step after
    # them does), plus the final seed emission.
    min_dec = max(1, min(pen.mismatch, pen.gap_extend))
    T_need = 2 * (int(score.max(initial=0)) // min_dec + 2) + 2
    T = -(-T_need // _TB_CHUNK_T) * _TB_CHUNK_T
    Bp = hist.shape[2]
    s0 = np.zeros(Bp, np.int32)
    k0 = np.zeros(Bp, np.int32)
    t0 = np.zeros(Bp, np.int32)
    lv = np.zeros(Bp, bool)
    s0[:B] = score
    k0[:B] = n1s - n2s
    t0[:B] = n2s
    lv[:B] = conv
    vals, lens, ok = _wfa_walk_device_jit(
        hist, jnp.asarray(s0), jnp.asarray(k0), jnp.asarray(t0),
        jnp.asarray(lv), k_lo=result.k_lo, g=g, T=T,
        x_pen=pen.mismatch, o_pen=pen.gap_open, e_pen=pen.gap_extend,
    )
    vals, lens, ok = jax.device_get((vals[:B], lens[:B], ok[:B]))
    W = max(1, -(-int((n1s + n2s).max(initial=1)) // 16))
    packed = rle_expand_packed(
        vals, np.clip(lens, 0, None).astype(np.uint16), W
    )
    alns = decode_packed_alignments(packed, seqs1, seqs2)
    return [a if ok[b] else None for b, a in enumerate(alns)]


def wfa_ends_free_traceback_host(
    result: WfaBatchResult,
    b: int,
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties = WfaPenalties(),
) -> Tuple[int, str, str]:
    """Reconstruct one pair's bounded-ends-free alignment, with the free
    end skips assembled as end gaps (the textbook semi-global output
    layout: skipped chars aligned against '-' runs).  Returns
    (penalty, aligned_seq1, aligned_seq2)."""
    if not bool(np.asarray(result.converged)[b]):
        raise AlignmentError("WFA did not converge within band/s_max")
    s = int(np.asarray(result.score)[b])
    n1, n2 = len(seq1), len(seq2)
    dtar = n1 - n2
    k_end = int(np.asarray(result.end_k)[b])
    t_end = n2 if k_end <= dtar else n1 - k_end
    mid1, mid2, k0, t0 = _walk_hist(
        result, b, seq1, seq2, penalties, k_end, t_end
    )
    # Start skips: y0 = t0 + k0 free seq1 chars, x0 = t0 free seq2 chars
    # (one of them is 0).  End skips: n1 - y_end seq1 / n2 - x_end seq2.
    x0, y0 = t0, t0 + k0
    x1, y1 = t_end, t_end + k_end
    a1 = (
        seq1[:y0].decode("latin-1") + "-" * x0 + mid1
        + seq1[y1:].decode("latin-1") + "-" * (n2 - x1)
    )
    a2 = (
        "-" * y0 + seq2[:x0].decode("latin-1") + mid2
        + "-" * (n1 - y1) + seq2[x1:].decode("latin-1")
    )
    return s, a1, a2
