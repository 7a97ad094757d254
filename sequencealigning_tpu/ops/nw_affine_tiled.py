"""Tiled affine-gap NW (Gotoh) fill for arbitrarily long pairs -- the
framework's sequence-parallel axis on one device.

The streamed fill (ops.nw_affine_stream) keeps the whole lane dimension
(P ~ db length) in one row, which caps a pair at its MAX_LANES.  This
module removes the ceiling: the DP matrix is split into tiles of W lanes
along the db (x) axis, each tile is filled with the same anti-diagonal
Gotoh sweep, and the only coupling between consecutive tiles is the
boundary column at the tile edge -- M/D/H at x = (t+1)*W for every query
position y, O(n1) values instead of O(n1*n2).  A jax.lax.scan carries the
boundary arrays from tile to tile, so the entire fill is one jitted
dispatch regardless of length.  The reference has no length ceiling either
(src/needleman_wunsch_affine.rs:169-241 allocates the full Rc cell grid --
which makes ~100 kb pairs OOM there); this engine is exact at any length
in O(B * (W + n1)) device memory.

Per-tile sweep (lanes l = 0..W-1 hold x = x0 + l with x0 = t*W + 1; step g
holds cells with y = g - l):

  * interior cells: the merged-roll Gotoh recurrence of
    ops.nw_affine_stream._stream_step;
  * lane l == g is cell (x, 0): the x-chain boundary (compat keeps it in
    the I plane, needleman_wunsch_affine.rs:200-216), computed from the
    dynamic tile origin x0 so one kernel serves every tile;
  * lane 0 reads the carried boundary column: M(x0,y) = H_b(y-1) + sub,
    D(x0,y) = max(M_b(y) + o, D_b(y)) + e;
  * lane W-1's M/D/H are emitted per step as the next tile's boundary.

Score-only: per-pair M/I/D corner finals, captured where (x, y) ==
(n2, n1).  For alignments of long pairs combine the exact tiled score with
a banded fill + band doubling until the banded score matches (Ukkonen-
style verification; see models.gotoh).

The tile fills (_tile_fill_lax, _tile_fill_folded_lax) are jax.lax.scan
sweeps on every platform; a long-pair GPU kernel is ROADMAP R5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu.config import NEG_INF, ScoringScheme
from sequencealigning_tpu.io.encode import round_up as _round_up


def _col0_vals(x0, col_iota, scheme: ScoringScheme, compat: bool):
    """(M, I, D) at cells (x = x0 + lane, y = 0).  x0 is a traced scalar so
    one compiled fill serves every tile.  x >= 1 always (x0 = t*W + 1), so
    the origin cell never appears here."""
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    neg = jnp.int32(NEG_INF)
    xg = x0 + col_iota
    if compat:
        return neg, o + (xg + 1) * e, neg
    return neg, neg, o + xg * e


def _tile_step(
    H2, H1, M1, I1, D1, s1d,
    qc, hb1, mb, db_, g,
    s2v, col_iota, lane_0, col0_m, col0_i, col0_d,
    scheme: ScoringScheme, wildcard: bool, roll,
):
    """One anti-diagonal step of a tile.  qc/hb1/mb/db_: (B, 1) scalars for
    this step (query char y-1; boundary H(y-1), M(y), D(y) at x0-1).
    col0_*: per-lane x-chain values (hoisted per tile).  Returns
    (M, I, D, H, s1d_new)."""
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)

    s1d_n = jnp.where(lane_0, qc, roll(s1d))
    if wildcard:
        eq = (s1d_n & s2v) != 0
    else:
        eq = s1d_n == s2v
    sub = jnp.where(eq, jnp.int32(scheme.match_), jnp.int32(scheme.mismatch))

    # Merged-roll Gotoh (ops.nw_affine_stream._stream_step).
    t0 = M1 + o
    M = roll(H2) + sub
    D = roll(jnp.maximum(t0, D1)) + e
    I = jnp.maximum(t0, I1) + e

    # Lane 0: the carried boundary column replaces the rolled-in values.
    M = jnp.where(lane_0, hb1 + sub, M)
    D = jnp.where(lane_0, jnp.maximum(mb + o, db_) + e, D)

    # Lane l == g is cell (x, 0): the x-chain boundary (a barrier that
    # keeps pre-activation garbage from leaking into y >= 1 cells).
    lane_g = col_iota == g
    M = jnp.where(lane_g, col0_m, M)
    I = jnp.where(lane_g, col0_i, I)
    D = jnp.where(lane_g, col0_d, D)

    H = jnp.maximum(M, jnp.maximum(I, D))
    return M, I, D, H, s1d_n


# ---------------------------------------------------------------------------
# lax.scan tile fill (reference implementation)
# ---------------------------------------------------------------------------


def _tile_fill_lax(
    db_tile, qs, hb1s, mbs, dbs, n1v, n2v, x0, ngc: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool,
):
    """Fill one tile.  db_tile: (B, W) lane chars; qs/hb1s/mbs/dbs:
    (B, NGC) per-step scalars; x0: traced scalar tile origin.  Returns
    (fm, fi, fd, br_m, br_d, br_h) with br_* (B, NGC) indexed by step g
    (lane W-1's per-step emissions)."""
    B, W = db_tile.shape
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    lane_0 = col_iota == 0
    roll = lambda a: jnp.roll(a, 1, axis=1)
    c_m, c_i, c_d = _col0_vals(x0, col_iota, scheme, compat)
    neg = jnp.full((B, W), NEG_INF, jnp.int32)
    zeros = jnp.zeros((B, W), jnp.int32)
    lcap = n2v - x0  # capture lane per pair
    gcap = lcap + n1v  # capture step per pair

    def body(carry, g):
        H2, H1, M1, I1, D1, s1d, fm, fi, fd = carry
        pick = lambda a: jax.lax.dynamic_slice_in_dim(a, g, 1, 1)
        M, I, D, H, s1d = _tile_step(
            H2, H1, M1, I1, D1, s1d,
            pick(qs), pick(hb1s), pick(mbs), pick(dbs), g,
            db_tile, col_iota, lane_0, c_m, c_i, c_d,
            scheme, wildcard, roll,
        )
        cap = jnp.logical_and(g == gcap, col_iota == lcap)
        fm = fm + jnp.where(cap, M, 0)
        fi = fi + jnp.where(cap, I, 0)
        fd = fd + jnp.where(cap, D, 0)
        br = jnp.concatenate([M[:, -1:], D[:, -1:], H[:, -1:]], axis=1)
        return (H1, H, M, I, D, s1d, fm, fi, fd), br

    carry0 = (neg, neg, neg, neg, neg, zeros, zeros, zeros, zeros)
    carry, brs = jax.lax.scan(
        body, carry0, jnp.arange(ngc, dtype=jnp.int32)
    )
    fm, fi, fd = carry[6:]
    brs = jnp.moveaxis(brs, 0, 2)  # (B, 3, NGC)
    return fm, fi, fd, brs[:, 0], brs[:, 1], brs[:, 2]


# ---------------------------------------------------------------------------
# Tile orchestration (one jitted scan over tiles)
# ---------------------------------------------------------------------------


def _boundary0(n1v, ngc: int, scheme: ScoringScheme, compat: bool):
    """Closed-form x=0 boundary column (tile 0's left edge), as the three
    (B, NGC) step-indexed arrays (hb1 pre-shifted by one).  compat keeps
    the x=0 chain in D (needleman_wunsch_affine.rs:183-199)."""
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    neg = jnp.int32(NEG_INF)
    B = n1v.shape[0]
    y = jax.lax.broadcasted_iota(jnp.int32, (B, ngc), 1)
    m_b = jnp.where(y == 0, 0, neg)
    if compat:
        d_b = jnp.where(y == 0, neg, o + (y + 1) * e)
        h_b = jnp.where(y == 0, 0, o + (y + 1) * e)
    else:
        # textbook: the (0, y) chain lives in I; D stays -inf but H sees it.
        d_b = jnp.full_like(y, neg)
        h_b = jnp.where(y == 0, 0, o + y * e)
    hb1 = jnp.concatenate([jnp.full((B, 1), neg), h_b[:, :-1]], axis=1)
    return hb1, m_b, d_b


@functools.lru_cache(maxsize=32)
def _jitted_tiled(w, ngc, scheme, compat, wildcard):

    def run(query, db_tiles, x0s, n1v, n2v):
        # query: (B, L1) int8; db_tiles: (T, B, W) int8; x0s: (T,) int32.
        q = query.astype(jnp.int32)
        B = q.shape[0]
        # qs(g) = q[g-1]
        qs = jnp.pad(q, ((0, 0), (1, max(0, ngc - 1 - q.shape[1]))))
        qs = qs[:, :ngc]
        hb1, mb, db_b = _boundary0(n1v, ngc, scheme, compat)

        def tile_body(carry, xs):
            hb1, mb, db_b, fm, fi, fd = carry
            db_tile, x0 = xs
            fm_t, fi_t, fd_t, brm, brd, brh = _tile_fill_lax(
                db_tile.astype(jnp.int32), qs, hb1, mb, db_b, n1v, n2v,
                x0, ngc, scheme, compat, wildcard,
            )
            fm = fm + fm_t
            fi = fi + fi_t
            fd = fd + fd_t
            # Re-index lane-(W-1) emissions (by step g) to y for the next
            # tile: the value at y sits at g = y + W - 1; hb1 needs y - 1.
            pad = lambda a: jnp.pad(a, ((0, 0), (0, w)))
            mb_n = jax.lax.dynamic_slice_in_dim(pad(brm), w - 1, ngc, 1)
            db_n = jax.lax.dynamic_slice_in_dim(pad(brd), w - 1, ngc, 1)
            hb1_n = jax.lax.dynamic_slice_in_dim(pad(brh), w - 2, ngc, 1)
            return (hb1_n, mb_n, db_n, fm, fi, fd), None

        zeros = jnp.zeros((B, w), jnp.int32)
        carry0 = (hb1, mb, db_b, zeros, zeros, zeros)
        carry, _ = jax.lax.scan(tile_body, carry0, (db_tiles, x0s))
        fm, fi, fd = carry[3:]
        finals = jnp.stack([fm.sum(1), fi.sum(1), fd.sum(1)], axis=1)
        return finals

    return jax.jit(run)


def nw_affine_tiled_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    tile_lanes: int = 4096,
    chunk: int = 128,
) -> np.ndarray:
    """Exact Gotoh corner finals (B, 3) for pairs of ANY length.

    Score-only (no dirs): O(B * (tile_lanes + n1)) device memory.  Same
    finals contract as ops.nw_affine.nw_affine_batch(with_dirs=False).
    The lax.scan fill runs on every platform.
    chunk: the step axis is padded to a multiple of it.
    """
    B, L1 = query.shape
    _, L2 = db.shape
    W = _round_up(min(tile_lanes, max(L2, 128)), 128)
    T = max(1, -(-L2 // W))
    Bp = _round_up(max(B, 8), 8)
    n1p = _round_up(L1 + 1, chunk)
    ngc = n1p + W

    q = np.zeros((Bp, L1), np.int8)
    q[:B] = query
    d_all = np.zeros((Bp, T * W), np.int8)
    d_all[:B, :L2] = db
    db_tiles = np.ascontiguousarray(
        d_all.reshape(Bp, T, W).transpose(1, 0, 2)
    )
    x0s = (np.arange(T, dtype=np.int32) * W + 1).astype(np.int32)
    qlen = np.ones(Bp, np.int32)
    dlen = np.ones(Bp, np.int32)
    qlen[:B] = np.asarray(query_len, np.int32)
    dlen[:B] = np.asarray(db_len, np.int32)

    fn = _jitted_tiled(W, ngc, scheme, compat, wildcard)
    finals = fn(
        jnp.asarray(q), jnp.asarray(db_tiles), jnp.asarray(x0s),
        jnp.asarray(qlen)[:, None], jnp.asarray(dlen)[:, None],
    )
    finals = np.asarray(finals)[:B].astype(np.int32)

    # Pairs with n2 == 0 never hit a tile lane: closed-form corner
    # (cell (0, n1) is the x=0 boundary column).
    o, e = scheme.gap_open, scheme.gap_extend
    for b in range(B):
        if int(dlen[b]) == 0:
            n1 = int(qlen[b])
            if n1 == 0:
                finals[b] = (0, NEG_INF, NEG_INF)
            elif compat:
                finals[b] = (NEG_INF, NEG_INF, o + (n1 + 1) * e)
            else:
                finals[b] = (NEG_INF, o + n1 * e, NEG_INF)
    return finals


# ---------------------------------------------------------------------------
# Sublane-folded small-batch tile fill
# ---------------------------------------------------------------------------
#
# A few long pairs leave most of the 8 rows idle in the batched tile
# sweep.  The folded variant splits the 8-row axis into G = 8 // fold
# groups of `fold` consecutive sublanes; group p holds pair p, with `fold`
# CONSECUTIVE W-lane x-tiles of that pair on the group's sublanes.  One
# kernel invocation sweeps a virtual fold*W-wide tile per pair: cell (x, y)
# with x = x0 + (s % fold)*W + l lives at sublane s, lane l, and every
# (s, l) position of an anti-diagonal step holds a distinct cell -- full
# VPU occupancy at any B in 1..4 (fold = 8 at B=1 recovers the original
# single-pair fold).  The only cross-row machinery is the x-1 neighbor
# exchange across the sublane seam: lane 0 of sublane s reads lane W-1 of
# sublane s-1 (one sublane roll + one static slice + select); the roll
# also crosses group boundaries, but those cells are the per-group fold
# origins and are overridden by each pair's carried boundary column.
# Boundary columns couple virtual tiles exactly as before, with each
# group's edge at x = x0 + fold*W - 1 (the group's last sublane, lane
# W-1).  Per-pair corner capture runs under a scalar step window
# [glo, ghi] = [min, max] over pairs of the capture step n1+n2-x0, so the
# equal-length (and B=1) case pays for the masked read-modify-write only
# on the exact capture steps.


def _shift_x(a, lane_0, roll_l, roll_s):
    """Value of the x-1 neighbor for every (s, l): lane l-1 within the
    sublane, lane W-1 of sublane s-1 across the seam.  (0, 0)'s wrapped
    value is garbage -- callers override that cell with the carried
    boundary column."""
    up = roll_s(a)
    return jnp.where(lane_0, up[:, -1:], roll_l(a))


def _folded_step(
    H2, H1, M1, I1, D1, qw,
    qc, hb1, mb, db_, g,
    s2v, lane_iota, sub_off, s0l0, lane_0, x0,
    scheme: ScoringScheme, compat: bool, wildcard: bool,
    roll_l, roll_s,
):
    """One anti-diagonal step of the folded tile (shapes (8, W)).  qc/hb1/
    mb/db_ are (1, 1)-ish scalars for this step; sub_off = s*W per sublane
    ((8, 1)); s0l0/lane_0 hoisted masks.  Returns (M, I, D, H, qw_new)."""
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    neg = jnp.int32(NEG_INF)

    sx = lambda a: _shift_x(a, lane_0, roll_l, roll_s)
    qw_n = jnp.where(s0l0, qc, sx(qw))
    if wildcard:
        eq = (qw_n & s2v) != 0
    else:
        eq = qw_n == s2v
    sub = jnp.where(eq, jnp.int32(scheme.match_), jnp.int32(scheme.mismatch))

    t0 = M1 + o
    M = sx(H2) + sub
    D = sx(jnp.maximum(t0, D1)) + e
    I = jnp.maximum(t0, I1) + e

    # Fold-origin cell (s=0, l=0) = x = x0: the carried boundary column.
    M = jnp.where(s0l0, hb1 + sub, M)
    D = jnp.where(s0l0, jnp.maximum(mb + o, db_) + e, D)

    # y == 0 chain cell (x0 + g, 0): lane l = g - s*W of one sublane.
    l0mask = lane_iota == (g - sub_off)
    xg = x0 + g
    if compat:
        i_c = o + (xg + 1) * e
        d_c = neg
    else:
        i_c = neg
        d_c = o + xg * e
    M = jnp.where(l0mask, neg, M)
    I = jnp.where(l0mask, i_c, I)
    D = jnp.where(l0mask, d_c, D)

    H = jnp.maximum(M, jnp.maximum(I, D))
    return M, I, D, H, qw_n


def _tile_fill_folded_lax(
    db_tile, qs, hb1s, mbs, dbs, n2c, n12c, x0, glo, ghi, ngc: int,
    fold: int, scheme: ScoringScheme, compat: bool, wildcard: bool,
):
    """lax reference for the folded fill.  db_tile: (8, W), sublane group
    p*fold..(p+1)*fold-1 holding pair p's fold*W db lanes; qs/hb1s/mbs/
    dbs: (8, NGC) per-step columns (rows equal within a group); n2c/n12c:
    (8, 128) per-sublane n2 / n1+n2 (lane 0 meaningful); glo/ghi: the
    capture window (unused here -- the lax scan masks every step).
    Returns (fm, fi, fd (8, W), br_m, br_d, br_h (8, NGC) per-sublane
    last-lane emissions)."""
    del glo, ghi
    S, W = db_tile.shape
    lane_iota = jax.lax.broadcasted_iota(jnp.int32, (S, W), 1)
    sub_iota = jax.lax.broadcasted_iota(jnp.int32, (S, W), 0)[:, :1]
    sub_off = (sub_iota & (fold - 1)) * W
    lane_0 = lane_iota == 0
    s0l0 = jnp.logical_and(lane_0, sub_off == 0)
    xv = x0 + sub_off + lane_iota
    roll_l = lambda a: jnp.roll(a, 1, axis=1)
    roll_s = lambda a: jnp.roll(a, 1, axis=0)
    neg = jnp.full((S, W), NEG_INF, jnp.int32)
    zeros = jnp.zeros((S, W), jnp.int32)
    gcapc = n12c[:, :1] - x0
    capl = xv == n2c[:, :1]

    def body(carry, g):
        H2, H1, M1, I1, D1, qw, fm, fi, fd = carry
        pick = lambda a: jax.lax.dynamic_slice_in_dim(a, g, 1, 1)
        M, I, D, H, qw = _folded_step(
            H2, H1, M1, I1, D1, qw,
            pick(qs), pick(hb1s), pick(mbs), pick(dbs), g,
            db_tile, lane_iota, sub_off, s0l0, lane_0, x0,
            scheme, compat, wildcard, roll_l, roll_s,
        )
        cap = jnp.logical_and(g == gcapc, capl)
        fm = fm + jnp.where(cap, M, 0)
        fi = fi + jnp.where(cap, I, 0)
        fd = fd + jnp.where(cap, D, 0)
        br = jnp.stack([M[:, -1], D[:, -1], H[:, -1]], axis=0)  # (3, 8)
        return (H1, H, M, I, D, qw, fm, fi, fd), br

    carry0 = (neg, neg, neg, neg, neg, zeros, zeros, zeros, zeros)
    carry, brs = jax.lax.scan(
        body, carry0, jnp.arange(ngc, dtype=jnp.int32)
    )
    fm, fi, fd = carry[6:]
    brs = jnp.transpose(brs, (1, 2, 0))  # (3, 8, NGC)
    return fm, fi, fd, brs[0], brs[1], brs[2]


@functools.lru_cache(maxsize=16)
def _jitted_tiled_folded(w, ngc, fold, scheme, compat, wildcard):
    wv = fold * w

    def run(query, db_tiles, x0s, n1v, n2v):
        # query: (G, L1) int8; db_tiles: (T, 8, W) int8; x0s: (T,) int32;
        # n1v/n2v: (G, 1) int32 with G = 8 // fold pair groups.
        G = n1v.shape[0]
        rep = lambda a: jnp.repeat(a, fold, axis=0)
        q = query.astype(jnp.int32)
        qs = jnp.pad(q, ((0, 0), (1, max(0, ngc - 1 - q.shape[1]))))
        qs = rep(qs[:, :ngc])
        hb1, mb, db_b = _boundary0(n1v, ngc, scheme, compat)
        hb1, mb, db_b = rep(hb1), rep(mb), rep(db_b)
        n12 = n1v + n2v
        n2c = rep(n2v)
        n12c = rep(n12)
        glo_all = jnp.min(n12)
        ghi_all = jnp.max(n12)

        def tile_body(carry, xs):
            hb1, mb, db_b, fm, fi, fd = carry
            db_tile, x0 = xs
            fm_t, fi_t, fd_t, brm, brd, brh = _tile_fill_folded_lax(
                db_tile.astype(jnp.int32), qs, hb1, mb, db_b, n2c, n12c,
                x0, glo_all - x0, ghi_all - x0, ngc, fold,
                scheme, compat, wildcard,
            )
            fm = fm + fm_t
            fi = fi + fi_t
            fd = fd + fd_t
            # Each group's virtual tile edge is its LAST sublane (x =
            # x0 + fold*W - 1): select edge rows, refan to the group's
            # sublanes, re-index the per-step emissions by y.
            edge = lambda a: rep(a[fold - 1::fold])
            pad = lambda a: jnp.pad(edge(a), ((0, 0), (0, wv)))
            mb_n = jax.lax.dynamic_slice_in_dim(pad(brm), wv - 1, ngc, 1)
            db_n = jax.lax.dynamic_slice_in_dim(pad(brd), wv - 1, ngc, 1)
            hb1_n = jax.lax.dynamic_slice_in_dim(pad(brh), wv - 2, ngc, 1)
            return (hb1_n, mb_n, db_n, fm, fi, fd), None

        zeros = jnp.zeros((8, w), jnp.int32)
        carry0 = (hb1, mb, db_b, zeros, zeros, zeros)
        carry, _ = jax.lax.scan(tile_body, carry0, (db_tiles, x0s))
        fm, fi, fd = carry[3:]
        red = lambda a: a.reshape(G, fold * w).sum(axis=1)
        finals = jnp.stack([red(fm), red(fi), red(fd)], axis=1)
        return finals  # (G, 3)

    return jax.jit(run)


def nw_affine_tiled_fold_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    tile_lanes: int = 8192,
    chunk: int = 128,
) -> np.ndarray:
    """Exact Gotoh corner finals (B, 3) for a SMALL batch (B <= 4) of long
    pairs, each pair folded over 8 // ceil_pow2(B) consecutive rows --
    all 8 rows busy in ONE dispatch where the plain batched sweep would
    idle most of them.  B > 4 falls through to the batched sweep.

    Every pair is padded to the longest pair's virtual tile grid, so the
    single dispatch computes G * max(cells) work: batch similar-length
    pairs (the model layer checks sum(cells) against G * max(cells))."""
    B, L1 = query.shape
    _, L2 = db.shape
    if B > 4:
        return nw_affine_tiled_batch(
            query, db, query_len, db_len, scheme=scheme, compat=compat,
            wildcard=wildcard, chunk=chunk,
        )
    G = 1 if B == 1 else (2 if B == 2 else 4)
    fold = 8 // G
    W = _round_up(min(tile_lanes, max(-(-max(L2, 1) // fold), 128)), 128)
    WV = fold * W
    T = max(1, -(-L2 // WV))
    n1p = _round_up(L1 + 1, chunk)
    ngc = _round_up(n1p + WV, chunk)

    q = np.zeros((G, L1), np.int8)
    q[:B] = query
    d_all = np.zeros((G, T * WV), np.int8)
    d_all[:B, :L2] = db
    db_tiles = np.ascontiguousarray(
        d_all.reshape(G, T, fold, W).transpose(1, 0, 2, 3).reshape(T, 8, W)
    )
    x0s = (np.arange(T, dtype=np.int32) * WV + 1).astype(np.int32)
    # Pad rows reuse pair 0's lengths so they don't widen the capture
    # window; their garbage finals are sliced off below.
    qlen = np.full(G, int(np.asarray(query_len)[0]), np.int32)
    dlen = np.full(G, int(np.asarray(db_len)[0]), np.int32)
    qlen[:B] = np.asarray(query_len, np.int32)
    dlen[:B] = np.asarray(db_len, np.int32)

    fn = _jitted_tiled_folded(W, ngc, fold, scheme, compat, wildcard)
    finals = fn(
        jnp.asarray(q), jnp.asarray(db_tiles), jnp.asarray(x0s),
        jnp.asarray(qlen)[:, None], jnp.asarray(dlen)[:, None],
    )
    finals = np.asarray(finals)[:B].astype(np.int32)

    # Pairs with n2 == 0 never hit a tile lane: closed-form corner
    # (cell (0, n1) is the x=0 boundary column).
    o, e = scheme.gap_open, scheme.gap_extend
    for b in range(B):
        if int(dlen[b]) == 0:
            n1 = int(qlen[b])
            if n1 == 0:
                finals[b] = (0, NEG_INF, NEG_INF)
            elif compat:
                finals[b] = (NEG_INF, NEG_INF, o + (n1 + 1) * e)
            else:
                finals[b] = (NEG_INF, o + n1 * e, NEG_INF)
    return finals


def nw_affine_tiled_single(
    query: bytes,
    db: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    tile_lanes: int = 8192,
    chunk: int = 128,
) -> np.ndarray:
    """Exact Gotoh corner finals (3,) for ONE pair of any length, with the
    db axis folded over all 8 rows (the batched tiled fill leaves 7/8 rows
    idle at B=1).  The B=1 case of
    nw_affine_tiled_fold_batch."""
    from sequencealigning_tpu.io.encode import encode_seq

    n1, n2 = len(query), len(db)
    q = np.zeros((1, max(n1, 1)), np.int8)
    d = np.zeros((1, max(n2, 1)), np.int8)
    if n1:
        q[0] = encode_seq(query)
    if n2:
        d[0] = encode_seq(db)
    return nw_affine_tiled_fold_batch(
        q, d, np.array([n1]), np.array([n2]), scheme=scheme, compat=compat,
        wildcard=wildcard, tile_lanes=tile_lanes, chunk=chunk,
    )[0]


def _pack_one(query: bytes, db: bytes):
    from sequencealigning_tpu.io.encode import pack_batch

    b = pack_batch([(query, db)], batch_size=1)
    return b.query, b.db, b.query_len, b.db_len
