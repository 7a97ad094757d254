"""Banded affine-gap NW fill (fixed-shape masked band) -- the batched
analog of the reference's A* pruning (SURVEY.md §5 "long-context": a fixed
band instead of a heap search; src/align.rs's weighted heuristic effectively
explores a corridor around the main diagonal).

Design: work in band coordinates (x, k) with k = y - x in a fixed static
range [k_lo, k_hi] (the corridor that contains every pair's global-alignment
diagonal +/- the band half-width).  Sweeping rows x = 0..L2:

  * M(x,k) <- H(x-1, k)          -- same lane, previous row (k unchanged)
  * D(x,k) <- M/D(x-1, k+1)      -- lane k+1, previous row
  * I(x,k) <- M/I(x, k-1)        -- same row: a first-order (max,+)
    recurrence I[k] = max(c[k], I[k-1]+e).  Because the extend penalty e is
    a constant, it linearizes: I[k] = k*e + prefixmax_j<=k (c[j] - j*e) --
    a plain running max (lax.cummax).

Cells with y = x + k outside [0, n1] (or outside the pair's true lengths)
are masked to -inf.  One byte of direction bits per cell (ops.dirbits
layout), packed 4 ROWS per u32 word: word = dirs[x//4, b, k-k_lo].

Row chars ride a rolling lane buffer (s1w): row x needs seq1[x-1+k_lo+k] at
lane k, and consecutive rows shift by exactly one lane, so each row is one
lane roll plus one scalar insert at the top lane -- no gathers, no unaligned
dynamic slices.

Scores equal the full Gotoh fill whenever the optimal path stays inside the
band (tests assert this), and are exactly the band-restricted optimum
otherwise -- the usual banded-alignment contract.

_banded_fill_lax is the jax.lax.scan implementation.  Production banded
alignment runs the anti-diagonal fill (ops.nw_banded_diag); this row
sweep stays as its cross-check (tests assert equal finals).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu.config import NEG_INF, ScoringScheme
from sequencealigning_tpu.io.encode import round_up as _round_up
from sequencealigning_tpu.ops import dirbits

NEGBIG = -(2 ** 24)  # band-mask -inf, must stay << any score
_SCAN_FILL = -(2 ** 28)  # prefix-max identity, << NEGBIG - K*|e|


class BandedResult(NamedTuple):
    finals: jax.Array  # (B, 3) M/I/D at (n2, n1)
    dirs: Optional[jax.Array]  # (X4, B, K) uint32
    k_lo: int


# ---------------------------------------------------------------------------
# Shared single-row step
# ---------------------------------------------------------------------------


def _row0_values(kv, n1v, scheme: ScoringScheme, compat: bool, dirs_mode):
    """Boundary row x=0: cell (0, y=k) for k >= 0, band-masked.  Returns
    (M0, I0, D0, H0, b0) with b0 the row-0 dirs byte (H-argmax bits only,
    needed by M cells at x=1; plane code in fast4 mode)."""
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    neg = jnp.int32(NEG_INF)
    y = kv
    on = jnp.logical_and(y >= 0, y <= n1v)
    is_origin = y == 0
    if compat:
        chain = o + (y + 1) * e
        m0 = jnp.where(is_origin, 0, neg)
        i0 = jnp.full_like(kv, neg)
        d0 = jnp.where(is_origin, neg, chain)
    else:
        chain = o + y * e
        m0 = jnp.where(is_origin, 0, neg)
        i0 = jnp.where(is_origin, neg, chain)
        d0 = jnp.full_like(kv, neg)
    mask = lambda a: jnp.where(on, a, NEGBIG)
    M0, I0, D0 = mask(m0), mask(i0), mask(d0)
    H0 = jnp.maximum(M0, jnp.maximum(I0, D0))
    if dirs_mode == "fast4":
        b0 = jnp.where(M0 == H0, 0, jnp.where(I0 == H0, 1, 2))
    else:
        b0 = (M0 == H0).astype(jnp.int32) * dirbits.HM
        b0 |= (I0 == H0).astype(jnp.int32) * dirbits.HI
        b0 |= (D0 == H0).astype(jnp.int32) * dirbits.HD
    return M0, I0, D0, H0, b0


def _banded_row_step(
    Mp, Dp, Hp, s1w,
    qin_c, dc_c, x,
    kv, lane_iota, le, n1v, n2v, k_lo: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
    roll, prefix_max,
):
    """Compute row x (x >= 1) from row x-1.

    dirs_mode: False/None (score only), "full"/True (7 tie bits per cell,
    co-optimal enumeration), or "fast4" (4 bits per cell, first-path walk).

    Shapes: state (B, K) int32; qin_c/dc_c (B, 1) -- the char entering lane
    K-1 of the rolling query window, and seq2[x-1]; x scalar.  Hoisted
    consts: kv = k_lo + lane, lane_iota, le = lane * e.  roll(a, s) is a
    backend lane roll (positive = toward higher lanes, wrapping -- callers
    mask the wrap); prefix_max(v) is an inclusive running max over lanes.
    Returns (M, I, D, H, s1w_new, byte).
    """
    K = kv.shape[1]
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    neg = jnp.int32(NEG_INF)

    lane_last = lane_iota == K - 1
    lane_0 = lane_iota == 0

    # Rolling query window: s1w[k] = seq1[x-1+k_lo+k] for this row.
    s1w_new = jnp.where(lane_last, qin_c, roll(s1w, -1))

    y = x + kv
    valid = jnp.logical_and(
        jnp.logical_and(y >= 1, y <= n1v), x <= n2v
    )

    if wildcard:
        eq = (s1w_new & dc_c) != 0  # N-matches-anything (align.rs:298-304)
    else:
        eq = s1w_new == dc_c
    sub = jnp.where(eq, jnp.int32(scheme.match_), jnp.int32(scheme.mismatch))

    M = Hp + sub
    # D: lane k+1 of previous row = shift toward lane 0 (band edge -> -inf).
    Mp_r = jnp.where(lane_last, NEGBIG, roll(Mp, -1))
    Dp_r = jnp.where(lane_last, NEGBIG, roll(Dp, -1))
    dd = Mp_r + o
    D = jnp.maximum(dd, Dp_r) + e

    Mv = jnp.where(valid, M, NEGBIG)
    Dv = jnp.where(valid, D, NEGBIG)

    # Column boundary y=0 (k = -x): chain values
    # (needleman_wunsch_affine.rs:200-216 in compat mode).
    if compat:
        chain = o + (x + 1) * e
        i_c = jnp.where(x == 0, neg, chain)
        d_c = neg
    else:
        chain = o + x * e
        i_c = neg
        d_c = jnp.where(x == 0, neg, chain)
    m_c = jnp.where(x == 0, 0, neg)

    # I: in-row first-order recurrence.  c[k] = M(x, k-1) + o + e; with the
    # constant extend penalty it linearizes, and the +o+e and the k*e
    # transform fold into one hoisted per-lane constant:
    #   I[k] = k*e + prefixmax_j<=k (M_l[j] + (o + e - j*e)).
    oele = o + e - le

    is_col0 = y == 0
    M = jnp.where(is_col0, m_c, Mv)
    D = jnp.where(is_col0, d_c, Dv)
    M_l = jnp.where(lane_0, NEGBIG, roll(M, 1))
    # The scan lane right of the col0 lane is seeded with i_chain + e so
    # the chain continues into the band.  y is linear in the lane index, so
    # that neighbor lane is simply y==1 (no bool roll).  No max against
    # M_l there: M_l at that lane is
    # the col0 M (0 or -inf), and -inf + o + e < chain + e always holds
    # within the col0-live rows x <= -k_lo.
    right_of_col0 = jnp.logical_and(jnp.logical_not(lane_0), y == 1)
    v = jnp.where(right_of_col0, i_c + e - le, M_l + oele)
    I = prefix_max(v) + le
    I = jnp.where(is_col0, i_c, jnp.where(valid, I, NEGBIG))

    H = jnp.maximum(M, jnp.maximum(I, D))

    byte = None
    if dirs_mode == "full" or dirs_mode is True:
        b = (M == H).astype(jnp.int32) * dirbits.HM
        b |= (I == H).astype(jnp.int32) * dirbits.HI
        b |= (D == H).astype(jnp.int32) * dirbits.HD
        # I-parent bits: I == I_prev_lane + e (ext) / == M_prev_lane + o + e.
        I_l = jnp.where(lane_0, NEGBIG, roll(I, 1))
        b |= (I == I_l + e).astype(jnp.int32) * dirbits.IEXT
        b |= (I == M_l + o + e).astype(jnp.int32) * dirbits.IOPEN
        b |= (D == Dp_r + e).astype(jnp.int32) * dirbits.DEXT
        b |= (D == dd + e).astype(jnp.int32) * dirbits.DOPEN
        byte = b
    elif dirs_mode == "fast4":
        # 4-bit first-path code (same semantics as nw_affine_stream fast4):
        # bits [0:2] = H-argmax plane, M > I > D priority; bit 2 = I-extend;
        # bit 3 = D-extend.
        I_l = jnp.where(lane_0, NEGBIG, roll(I, 1))
        b = jnp.where(M == H, 0, jnp.where(I == H, 1, 2))
        b |= (I == I_l + e).astype(jnp.int32) * 4
        b |= (D == Dp_r + e).astype(jnp.int32) * 8
        byte = b

    return M, I, D, H, s1w_new, byte


def _device_row_streams(seq1, seq2, k_lo: int, K: int, l2: int, xp: int):
    """XLA-side stream prep from (B, L) int code batches: (s1w0, qin, dcs).

    s1w0: (B, K) row-0 query window (so the first roll yields row 1's);
    qin:  (B, Xp) char entering lane K-1 at row x;
    dcs:  (B, Xp) db char for row x (= seq2[x-1], -1 padding elsewhere).

    Runs inside the jitted fill so host->device traffic stays at the raw
    1-byte/char sequences (the padded int32 streams are ~8x fatter).
    """
    assert k_lo <= 0, k_lo  # the qin offset below relies on pad_l = 1 - k_lo
    q = seq1.astype(jnp.int32)
    d = seq2.astype(jnp.int32)
    L1 = q.shape[1]
    L2 = d.shape[1]
    pad_l = 1 - k_lo
    # Row x's incoming top-lane char is seq1[x - 1 + k_lo + (K-1)], i.e.
    # qin[x] = seq1_pad[x + K - 1]; s1w0 = seq1_pad[0:K] (row-0 window).
    pad_r = max(0, (K - 1 + xp) - (pad_l + L1), K - pad_l - L1)
    s1p = jnp.pad(q, ((0, 0), (pad_l, pad_r)), constant_values=-1)
    s1w0 = jax.lax.slice_in_dim(s1p, 0, K, axis=1)
    qin = jax.lax.slice_in_dim(s1p, K - 1, K - 1 + xp, axis=1)
    n = min(l2, L2, xp - 1)
    dcs = jnp.pad(
        d[:, :n], ((0, 0), (1, xp - 1 - n)), constant_values=-1
    )
    return s1w0, qin, dcs


# ---------------------------------------------------------------------------
# lax.scan reference implementation
# ---------------------------------------------------------------------------


def _banded_fill_lax(
    s1w0, qin, dcs, n1v, n2v, k_lo: int, l2: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
):
    B, K = s1w0.shape
    e = jnp.int32(scheme.gap_extend)
    kv = k_lo + jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)
    lane_iota = jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)
    le = lane_iota * e
    roll = lambda a, s: jnp.roll(a, s, axis=1)
    prefix_max = lambda v: jax.lax.cummax(v, axis=1)

    M0, I0, D0, H0, b0 = _row0_values(kv, n1v, scheme, compat, dirs_mode)

    def body(carry, x):
        Mp, Dp, Hp, s1w, fm, fi, fd = carry
        qin_c = jax.lax.dynamic_slice_in_dim(qin, x, 1, 1)
        dc_c = jax.lax.dynamic_slice_in_dim(dcs, x, 1, 1)
        M, I, D, H, s1w, byte = _banded_row_step(
            Mp, Dp, Hp, s1w, qin_c, dc_c, x,
            kv, lane_iota, le, n1v, n2v, k_lo,
            scheme, compat, wildcard, dirs_mode, roll, prefix_max,
        )
        cap = jnp.logical_and(x == n2v, kv == (n1v - n2v))
        fm = fm + jnp.where(cap, M, 0)
        fi = fi + jnp.where(cap, I, 0)
        fd = fd + jnp.where(cap, D, 0)
        out = byte.astype(jnp.uint8) if dirs_mode else jnp.zeros((), jnp.uint8)
        return (M, D, H, s1w, fm, fi, fd), out

    # Corner capture for pairs with n2 == 0 lives on row 0.
    cap0 = jnp.logical_and(n2v == 0, kv == n1v)
    carry0 = (
        M0, D0, H0, s1w0,
        jnp.where(cap0, M0, 0),
        jnp.where(cap0, I0, 0),
        jnp.where(cap0, D0, 0),
    )
    carry, bytes_ = jax.lax.scan(
        body, carry0, jnp.arange(1, l2 + 1, dtype=jnp.int32)
    )
    fm, fi, fd = carry[4:]
    finals = jnp.stack([fm.sum(1), fi.sum(1), fd.sum(1)], axis=1)

    if dirs_mode == "fast4":
        bytes_ = jnp.concatenate([b0.astype(jnp.uint8)[None], bytes_], axis=0)
        x8 = -(-(l2 + 1) // 8)
        bytes_ = jnp.pad(bytes_, ((0, x8 * 8 - (l2 + 1)), (0, 0), (0, 0)))
        w = bytes_.reshape(x8, 8, B, K).astype(jnp.uint32)
        dirs = w[:, 0]
        for u in range(1, 8):
            dirs = dirs | (w[:, u] << (4 * u))
    elif dirs_mode:
        bytes_ = jnp.concatenate([b0.astype(jnp.uint8)[None], bytes_], axis=0)
        dirs = dirbits.pack_bytes_to_words(bytes_, l2 + 1)
    else:
        dirs = None
    return finals, dirs


@functools.lru_cache(maxsize=64)
def _jitted_banded(k_lo, K, l2, xp, scheme, compat, wildcard, dirs_mode):
    """One jitted dispatch per configuration: device-side stream prep fused
    with the fill so each call ships only the raw int8 sequences."""

    def run(query, db, n1v, n2v):
        s1w0, qin, dcs = _device_row_streams(query, db, k_lo, K, l2, xp)
        return _banded_fill_lax(
            s1w0, qin, dcs, n1v, n2v, k_lo, l2,
            scheme, compat, wildcard, dirs_mode,
        )

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def nw_banded_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    band: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs=True,
) -> BandedResult:
    """Banded Gotoh fill.  band = half-width around each pair's global
    diagonal corridor; the static lane range covers
    [min(0, n1-n2)-band, max(0, n1-n2)+band] over the batch.

    with_dirs: True/"full" (7 tie bits per cell, co-optimal traceback via
    ops.traceback.banded_traceback_pair), "fast4" (4 bits per cell,
    first-path walk via banded_fast4_traceback_pair -- half the dirs
    traffic), or False (score only).  The lax.scan fill runs on every
    platform.
    """
    qlen = np.asarray(query_len)
    dlen = np.asarray(db_len)
    diff = qlen.astype(np.int64) - dlen.astype(np.int64)
    k_lo = int(min(0, diff.min()) - band)
    k_hi = int(max(0, diff.max()) + band)
    B, L1 = query.shape
    _, L2 = db.shape
    K = _round_up(k_hi - k_lo + 1, 128)
    dirs_mode = "full" if with_dirs is True else with_dirs

    fn = _jitted_banded(
        k_lo, K, L2, L2 + 1, scheme, compat, wildcard, dirs_mode
    )
    finals, dirs = fn(
        jnp.asarray(np.asarray(query, np.int8)),
        jnp.asarray(np.asarray(db, np.int8)),
        jnp.asarray(qlen, jnp.int32)[:, None],
        jnp.asarray(dlen, jnp.int32)[:, None],
    )
    finals = finals[:B]
    if dirs is not None and dirs.shape[1] != B:
        dirs = dirs[:, :B]
    return BandedResult(finals=finals, dirs=dirs, k_lo=k_lo)
