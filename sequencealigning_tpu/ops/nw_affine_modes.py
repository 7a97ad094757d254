"""Affine-gap NW in semi-global and local modes (textbook semantics).

The reference declares these "not implemented" for its affine NW
(needleman_wunsch_affine.rs:433-434, with empty fill/traceback stubs at
:238-239, :331-332); this module implements them on the same
anti-diagonal machinery as ops.nw_affine:

* semi-global: free end gaps in BOTH sequences (matching the A* variant's
  free-move rule at x in {0, n2} / y in {0, n1}, align.rs:59-123): boundary
  M rows/cols are 0, the score is max H over each pair's last row/column,
  and the alignment gets free leading/trailing gap columns.
* local (Smith-Waterman-affine): M = max(0, H_prev + sub), score = max M
  over all valid cells, traceback stops at the restart cell (LSTART bit).

Both return per-lane running argmax accumulators so the host can recover the
end cell without storing score matrices.  Single-alignment traceback
(deterministic tie priorities documented in ops.traceback).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu.config import NEG_INF, ScoringScheme
from sequencealigning_tpu.io.encode import round_up as _round_up
from sequencealigning_tpu.ops import dirbits
from sequencealigning_tpu.ops.nw_affine import _gotoh_step


class ModesResult(NamedTuple):
    """best/best_x/best_y: (B,) per-pair end cell (score, x, y), reduced
    on device from the fill's per-lane running-argmax buffers -- shipping
    the raw (B, P) buffers to the host costs 2*B*P*4 bytes per fill and
    dominates end-to-end time on any real interconnect.
    dirs: (D4, B, P) packed bytes (ops.dirbits layout + LSTART)."""

    best: np.ndarray
    best_x: np.ndarray
    best_y: np.ndarray
    dirs: Optional[jax.Array]


def modes_reduce(bv, bd):
    """Device-side per-pair end cell from per-lane argmax buffers.

    Returns (score, x, y) each (B,) int32.  Tie rule matches the former
    host reduction exactly: smallest lane (jnp.argmax returns the first
    maximum), then the lane's recorded earliest diagonal (the fills update
    on strict > only).  `best` is cast to int32 so the contract holds even
    when the streamed engine fills with state_dtype=jnp.int16."""
    best = jnp.max(bv, axis=1).astype(jnp.int32)
    lane = jnp.argmax(bv, axis=1).astype(jnp.int32)
    d = jnp.take_along_axis(bd, lane[:, None], axis=1)[:, 0]
    return best, lane, d - lane


@functools.partial(
    jax.jit,
    static_argnames=("l1", "l2", "scheme", "wildcard", "local", "with_dirs"),
)
def _fill_modes_lax(
    seq1, s2v, n1v, n2v, l1: int, l2: int,
    scheme: ScoringScheme, wildcard: bool, local: bool, with_dirs: bool,
):
    B, P = s2v.shape
    D_total = l1 + l2 + 1
    neg = jnp.full_like(s2v, NEG_INF)
    NEGBIG = jnp.int32(-(2 ** 24))
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    roll = lambda a: jnp.roll(a, 1, axis=1)
    mode = "local" if local else "semi"

    def body(carry, d):
        H2, H1, M1, I1, D1, s1d, bv, bd = carry
        idx = jnp.clip(d - 1, 0, seq1.shape[1] - 1)
        seq1_col = jax.lax.dynamic_slice_in_dim(seq1, idx, 1, axis=1)
        # One shared copy of the Gotoh recurrence + dirs emission
        # (ops.nw_affine._gotoh_step); only the boundary hook differs.
        M, I, D, H, s1d_new, byte = _gotoh_step(
            H2, H1, M1, I1, D1, s1d, seq1_col, s2v, col_iota, d,
            scheme, False, wildcard, roll, with_dirs, mode=mode,
        )

        # Validity within each pair's true rectangle.
        y = d - col_iota
        valid = jnp.logical_and(
            jnp.logical_and(col_iota >= 0, col_iota <= n2v),
            jnp.logical_and(y >= 0, y <= n1v),
        )
        if local:
            cand = jnp.logical_and(valid, jnp.logical_and(col_iota >= 1, y >= 1))
            score_here = M
        else:
            last_row = col_iota == n2v
            last_col = y == n1v
            cand = jnp.logical_and(valid, jnp.logical_or(last_row, last_col))
            score_here = H
        upd = jnp.logical_and(cand, score_here > bv)
        bv = jnp.where(upd, score_here, bv)
        bd = jnp.where(upd, d, bd)

        out = byte.astype(jnp.uint8) if with_dirs else jnp.zeros((), jnp.uint8)
        return (H1, H, M, I, D, s1d_new, bv, bd), out

    zeros = jnp.zeros_like(s2v)
    carry0 = (
        neg, neg, neg, neg, neg, zeros,
        jnp.full_like(s2v, NEGBIG), zeros,
    )
    carry, bytes_ = jax.lax.scan(
        body, carry0, jnp.arange(D_total, dtype=jnp.int32)
    )
    bv, bd = carry[6], carry[7]
    if with_dirs:
        dirs = dirbits.pack_bytes_to_words(bytes_, D_total)
    else:
        dirs = None
    return bv, bd, dirs


def nw_affine_modes_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    local: bool,
    scheme: ScoringScheme = ScoringScheme(),
    wildcard: bool = False,
    with_dirs: bool = True,
) -> ModesResult:
    """Batched semi-global (local=False) or local (local=True) affine fill
    (the lax.scan fill, on every platform).

    Eager host-level entry point (it stages inputs with NumPy): the
    (B,) end-cell triple is fetched to the host in one device_get — a
    12 bytes/pair blocking sync — while `dirs` stays on device.  Not
    callable under an outer jit/trace.
    """
    B, L1 = query.shape
    _, L2 = db.shape
    P = _round_up(L2 + 1, 128)
    s2v = np.zeros((B, P), dtype=np.int32)
    s2v[:, 1 : L2 + 1] = db
    n1v = jnp.asarray(query_len, jnp.int32)[:, None]
    n2v = jnp.asarray(db_len, jnp.int32)[:, None]
    bv, bd, dirs = _fill_modes_lax(
        jnp.asarray(query, jnp.int32), jnp.asarray(s2v), n1v, n2v,
        L1, L2, scheme, wildcard, local, with_dirs,
    )
    best, x, y = modes_reduce(bv, bd)
    best, x, y = jax.device_get((best, x, y))
    return ModesResult(best=best, best_x=x, best_y=y, dirs=dirs)


def modes_end_cell(
    result: ModesResult, b: int
) -> Tuple[int, int, int]:
    """(score, x, y) of pair b's best end cell (reduced on device; ties
    resolve to the smallest lane x, then smallest diagonal)."""
    return (
        int(result.best[b]), int(result.best_x[b]), int(result.best_y[b])
    )
