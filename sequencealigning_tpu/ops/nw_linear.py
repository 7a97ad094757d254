"""Batched linear/gap-state Needleman-Wunsch fill (anti-diagonal, JAX).

Batched re-design of the reference's dead linear module
(src/needleman_wunsch.rs, revived as Algo.NW_LINEAR): single score plane +
per-cell gap flag, swept along anti-diagonals exactly like ops.nw_affine
(lanes = db axis, rows = batch).  Supports the reference's global mode
(with its double-initialized origin, compat) and its Smith-Waterman-style
local mode (negative cells keep score 0 with cleared paths and traceback
starts from every argmax cell, needleman_wunsch.rs:88-90, 106-116).

Direction bits per cell (packed 4 diagonals / u32 like ops.dirbits):
  bit0 DOWN  (consume seq1/query, gap in db)
  bit1 RIGHT (consume seq2/db, gap in query)
  bit2 DIAG
  bit3 ISMAX (local mode only: cell score equals the pair's global max)
Bit push order DOWN, RIGHT, DIAG matches the reference's path list
(:92-100), whose DFS explores in insertion order.

Local mode runs two passes: pass 1 computes each pair's max, pass 2 emits
bits including ISMAX.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu.ops import dirbits
from sequencealigning_tpu.config import ScoringScheme

LDOWN, LRIGHT, LDIAG, LISMAX = 1, 2, 4, 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class LinearResult(NamedTuple):
    """score: (B,) int32 -- corner score (global) or matrix max (local).
    dirs: (D4, B, P) uint32 packed path bits (None in score-only mode)."""

    score: jax.Array
    dirs: Optional[jax.Array]


@functools.partial(
    jax.jit,
    static_argnames=(
        "scheme", "compat", "local", "with_dirs", "l1", "l2",
    ),
)
def _linear_fill_lax(
    seq1, s2v, dsum, n2mask, n1v, n2v, maxv, l1: int, l2: int,
    scheme: ScoringScheme, compat: bool, local: bool, with_dirs: bool,
):
    """One sweep.  maxv: (B,1) per-pair max from pass 1 (zeros for pass 1 /
    global).  Returns (corner_score, running_max, bytes(D,B,P) or None)."""
    B, P = s2v.shape
    D_total = l1 + l2 + 1
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    NEGBIG = jnp.int32(-(2 ** 30))
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)

    def body(carry, d):
        S2, S1, G1, s1d, corner, runmax = carry
        idx = jnp.clip(d - 1, 0, seq1.shape[1] - 1)
        seq1_col = jax.lax.dynamic_slice_in_dim(seq1, idx, 1, axis=1)
        s1d_new = jnp.where(col_iota == 0, seq1_col, jnp.roll(s1d, 1, axis=1))

        eq = s1d_new == s2v  # plain equality (needleman_wunsch.rs:68)
        sub = jnp.where(eq, jnp.int32(scheme.match_), jnp.int32(scheme.mismatch))
        diag = jnp.roll(S2, 1, axis=1) + sub
        # DOWN consumes seq1 (same lane, d-1); RIGHT consumes seq2 (rolled).
        down_src, down_gap = S1, G1
        right_src, right_gap = jnp.roll(S1, 1, axis=1), jnp.roll(G1, 1, axis=1)
        if compat:
            down = down_src + jnp.where(down_gap, e, o)
            right = right_src + jnp.where(right_gap, e, o)
        else:
            down = down_src + e
            right = right_src + e
        mx = jnp.maximum(diag, jnp.maximum(down, right))
        gap_new = jnp.logical_or(mx == down, mx == right)
        if local:
            s_new = jnp.where(mx < 0, 0, mx)
        else:
            s_new = mx

        # Boundary overrides.
        lane_0 = col_iota == 0
        lane_d = col_iota == d
        is_origin = d == 0
        if local:
            bval = jnp.int32(0)
            borigin = jnp.int32(0)
            bgap = False
        elif compat:
            bval = d * e + o
            borigin = 2 * o
            bgap = True
        else:
            bval = d * e
            borigin = jnp.int32(0)
            bgap = True
        bscal = jnp.where(is_origin, borigin, bval)
        on_boundary = jnp.logical_or(lane_0, lane_d)
        s_new = jnp.where(on_boundary, bscal, s_new)
        gap_new = jnp.where(on_boundary, bgap, gap_new)

        # Validity (needed for local max / ISMAX; global corner capture is
        # exact anyway).
        valid = jnp.logical_and(col_iota <= n2v, col_iota >= d - n1v)
        valid = jnp.logical_and(valid, col_iota <= d)  # y = d - x >= 0
        valid = jnp.logical_and(valid, d <= dsum)

        cap = jnp.logical_and(dsum == d, n2mask)
        corner = corner + jnp.where(cap, s_new, 0)
        runmax = jnp.maximum(runmax, jnp.where(valid, s_new, NEGBIG))

        if with_dirs:
            b = (mx == down).astype(jnp.int32) * LDOWN
            b |= (mx == right).astype(jnp.int32) * LRIGHT
            b |= (mx == diag).astype(jnp.int32) * LDIAG
            if local:
                b = jnp.where(mx < 0, 0, b)  # paths cleared (:88-90)
                b |= (
                    jnp.logical_and(s_new == maxv, valid).astype(jnp.int32)
                    * LISMAX
                )
            # Boundary path bits.
            b_bound = jnp.where(lane_0, LDOWN, LRIGHT)
            b_bound = jnp.where(is_origin, LRIGHT | LDOWN, b_bound)
            if local:
                b_bound = jnp.where(
                    jnp.logical_and(s_new == maxv, valid), LISMAX, 0
                )
            b = jnp.where(on_boundary, b_bound, b)
            out = b.astype(jnp.uint8)
        else:
            out = jnp.zeros((), jnp.uint8)
        return (S1, s_new, gap_new, s1d_new, corner, runmax), out

    zeros = jnp.zeros((B, P), jnp.int32)
    neg = jnp.full((B, P), NEGBIG, jnp.int32)
    carry0 = (neg, neg, jnp.zeros((B, P), bool), zeros, zeros, neg)
    carry, bytes_ = jax.lax.scan(
        body, carry0, jnp.arange(D_total, dtype=jnp.int32)
    )
    _, _, _, _, corner, runmax = carry
    corner_score = corner.sum(axis=1)
    run_max = runmax.max(axis=1)
    if with_dirs:
        dirs = dirbits.pack_bytes_to_words(bytes_, D_total)
    else:
        dirs = None
    return corner_score, run_max, dirs


def nw_linear_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    local: bool = False,
    with_dirs: bool = True,
) -> LinearResult:
    """Batched linear/gap-state NW fill (see module docstring)."""
    B, L1 = query.shape
    _, L2 = db.shape
    P = _round_up(L2 + 1, 128)

    s2v = np.zeros((B, P), dtype=np.int32)
    s2v[:, 1 : L2 + 1] = db
    seq1 = np.asarray(query, dtype=np.int32)
    n1v = np.asarray(query_len, dtype=np.int32)[:, None]
    n2v = np.asarray(db_len, dtype=np.int32)[:, None]
    dsum = (n1v + n2v).astype(np.int32)
    n2mask = (
        np.arange(P, dtype=np.int32)[None, :] == np.asarray(db_len)[:, None]
    )

    a = (
        jnp.asarray(seq1), jnp.asarray(s2v), jnp.asarray(dsum),
        jnp.asarray(n2mask), jnp.asarray(n1v), jnp.asarray(n2v),
    )
    zeros_max = jnp.zeros((B, 1), jnp.int32)
    if local:
        _, run_max, _ = _linear_fill_lax(
            *a, zeros_max, L1, L2, scheme, compat, True, False
        )
        corner, run_max2, dirs = _linear_fill_lax(
            *a, run_max[:, None], L1, L2, scheme, compat, True, with_dirs
        )
        return LinearResult(score=run_max2, dirs=dirs)
    corner, _, dirs = _linear_fill_lax(
        *a, zeros_max, L1, L2, scheme, compat, False, with_dirs
    )
    return LinearResult(score=corner, dirs=dirs)
