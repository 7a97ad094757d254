"""Streamed-pair Gotoh fill in semi-global / local modes.

The textbook semi-global and local (Smith-Waterman-affine) modes -- the
reference declares them "not implemented" for its affine NW
(needleman_wunsch_affine.rs:433-434) -- on the FLAGSHIP streamed-pair
engine (ops.nw_affine_stream): each stream row pipelines a new pair into
the lane dimension every S steps, so the plain modes kernel's ~50% lane
occupancy (ops.nw_affine_modes) becomes ~90% and the fill rides the same
batch-scale amortization as the global headline.

Differences from the global streamed fill:

* boundary lanes 0 and p hold M = 0, I = D = -inf (free end gaps); local
  mode additionally clamps M = max(M, 0) with restarts recorded as the
  LSTART dirs bit (the _stream_step ``mode`` hook);
* the corner capture is replaced by per-slot running argmax bookkeeping:
  (best score, its pair-local diagonal) per lane and slot instead of
  (M, I, D) finals -- eligibility is every
  valid interior cell (local, score = M) or the last row/column (semi,
  score = H), exactly as ops.nw_affine_modes._fill_modes_lax;
* dirs are always the full byte layout (the modes walkers need the
  LSTART bit and plane-tie bytes).

Host recovery: stream_modes_best() -> (score, x, y) per pair; traceback
via ops.traceback.semi_global/local_affine_traceback_pair with
d_offset = slot * plan.s.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu.config import NEG_INF, ScoringScheme
from sequencealigning_tpu.ops.nw_affine_modes import modes_reduce
from sequencealigning_tpu.ops.nw_affine_stream import (
    StreamPlan,
    _stream_step,
    build_stream_inputs,
    plan_stream,
    resolve_stream_state,
    stream_i16_neg,
)

NEGBIG = -(2 ** 24)


class StreamModesResult(NamedTuple):
    """best/best_x/best_y: (B,) per-pair end cell (score, x, y), reduced
    on device (ops.nw_affine_modes.modes_reduce) from the kernel's
    per-lane running-argmax buffers.  dirs: packed full bytes in the
    streamed layout (word (k*S + x + y) // 4)."""

    best: np.ndarray
    best_x: np.ndarray
    best_y: np.ndarray
    dirs: Optional[jax.Array]
    plan: StreamPlan


def _mode_candidates(mode, M, I, D, H, col_iota, p, dsv, n2v):
    """(eligibility mask, score) for the running argmax at local diag p of
    the pair with per-row (n1+n2, n2) = (dsv, n2v) (each (BT, 1) or -1 for
    drain slots).  Mirrors ops.nw_affine_modes._fill_modes_lax."""
    n1v = dsv - n2v
    y = p - col_iota
    # Drain slots carry (dsv, n2v) = (-1, -1): x <= n2v is then empty, so
    # no separate liveness mask is needed.
    if mode == "local":
        elig = jnp.logical_and(
            jnp.logical_and(col_iota >= 1, col_iota <= n2v),
            jnp.logical_and(y >= 1, y <= n1v),
        )
        score = M
    else:
        valid = jnp.logical_and(
            jnp.logical_and(col_iota >= 0, col_iota <= n2v),
            jnp.logical_and(y >= 0, y <= n1v),
        )
        elig = jnp.logical_and(
            valid, jnp.logical_or(col_iota == n2v, y == n1v)
        )
        score = H
    return elig, score


# ---------------------------------------------------------------------------
# lax.scan reference implementation
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "scheme", "wildcard", "mode", "with_dirs", "state_dtype"
    ),
)
def gotoh_fill_stream_modes_lax(
    qstream, dstream, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    wildcard: bool, mode: str, with_dirs: bool,
    state_dtype=jnp.int32,
):
    """qstream/dstream: (n_rows, t_total) int32; dsums/n2s:
    (np_slots, n_rows) int32.  Returns (bv, bd) each (np_slots, n_rows, P)
    plus packed dirs or None."""
    assert mode in ("semi", "local"), mode
    R = qstream.shape[0]
    P = plan.p
    neg_sent = None
    if state_dtype == jnp.int16:
        neg_sent = stream_i16_neg(scheme, plan)
        if neg_sent is None:
            raise ValueError("scheme x shape does not fit int16 state")
    neg = (
        jnp.full((R, P), NEGBIG, jnp.int32)
        if neg_sent is None
        else jnp.full((R, P), neg_sent, state_dtype)
    )
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (R, P), 1)
    lane_0 = col_iota == 0
    roll = lambda a: jnp.roll(a, 1, axis=1)
    s = jnp.int32(plan.s)
    dirs_mode = "full" if with_dirs else False

    def body(carry, t):
        H2, H1, M1, I1, D1, s1d, s2v, bv, bd = carry
        p = t % s
        qc = jax.lax.dynamic_slice_in_dim(qstream, t, 1, axis=1)
        dc = jax.lax.dynamic_slice_in_dim(dstream, t, 1, axis=1)
        M, I, D, H, s1d, s2v, byte = _stream_step(
            H2, H1, M1, I1, D1, s1d, s2v, qc, dc, col_iota, lane_0, p,
            scheme, False, wildcard, roll, dirs_mode, mode=mode,
            neg_sent=NEG_INF if neg_sent is None else neg_sent,
        )
        for k in range(plan.np_slots):
            pk = t - k * plan.s
            elig, score = _mode_candidates(
                mode, M, I, D, H, col_iota, pk,
                dsums[k][:, None], n2s[k][:, None],
            )
            score = score.astype(jnp.int32)
            elig = jnp.logical_and(elig, pk >= 0)
            upd = jnp.logical_and(elig, score > bv[k])
            bv = bv.at[k].set(jnp.where(upd, score, bv[k]))
            bd = bd.at[k].set(jnp.where(upd, pk, bd[k]))
        out = byte.astype(jnp.uint8) if with_dirs else jnp.zeros((), jnp.uint8)
        return (H1, H, M, I, D, s1d, s2v, bv, bd), out

    zeros = jnp.zeros((R, P), jnp.int32)
    bz = jnp.full((plan.np_slots, R, P), NEGBIG, jnp.int32)
    carry0 = (
        neg, neg, neg, neg, neg, zeros, zeros, bz,
        jnp.zeros_like(bz),
    )
    carry, bytes_ = jax.lax.scan(
        body, carry0, jnp.arange(plan.t_total, dtype=jnp.int32)
    )
    bv, bd = carry[7], carry[8]
    if with_dirs:
        T4 = plan.t_total // 4
        w = bytes_.reshape(T4, 4, R, P).astype(jnp.uint32)
        dirs = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    else:
        dirs = None
    return (bv, bd), dirs


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def nw_affine_stream_modes_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    mode: str,
    scheme: ScoringScheme = ScoringScheme(),
    wildcard: bool = False,
    with_dirs: bool = True,
    np_slots: Optional[int] = None,
    chunk: int = 128,
    state_dtype=jnp.int32,
) -> StreamModesResult:
    """Streamed batched semi-global/local Gotoh fill.  mode in
    ("semi", "local").  Use stream_modes_best() for the (score, x, y)
    end cell per pair.  The lax.scan fill runs on every platform (a
    mode of the CUDA streamed fill is ROADMAP work).
    state_dtype: dtype or "i32"/"i16"/"auto" (resolve_stream_state).

    Eager host-level entry point (it stages inputs with NumPy): the
    (B,) end-cell triple is fetched to the host in one device_get — a
    12 bytes/pair blocking sync — while `dirs` stays on device.  Not
    callable under an outer jit/trace."""
    assert mode in ("semi", "local"), mode
    B, L1 = query.shape
    _, L2 = db.shape
    plan = plan_stream(B, L1, L2, chunk=chunk, np_slots=np_slots)
    state_dtype = resolve_stream_state(state_dtype, scheme, plan)
    NP, R = plan.np_slots, plan.n_rows
    n_padded = NP * R

    q_all = np.zeros((n_padded, L1), np.int8)
    d_all = np.zeros((n_padded, L2), np.int8)
    q_all[:B] = query
    d_all[:B] = db
    qlen = np.ones(n_padded, np.int32)
    dlen = np.ones(n_padded, np.int32)
    qlen[:B] = np.asarray(query_len, np.int32)
    dlen[:B] = np.asarray(db_len, np.int32)

    qstream, dstream, dsums, n2s = build_stream_inputs(
        q_all.astype(np.int32), d_all.astype(np.int32),
        qlen, dlen, plan,
    )
    (bv_k, bd_k), dirs = gotoh_fill_stream_modes_lax(
        jnp.asarray(qstream), jnp.asarray(dstream),
        jnp.asarray(dsums), jnp.asarray(n2s),
        plan, scheme, wildcard, mode, with_dirs,
        state_dtype=state_dtype,
    )
    bv = jnp.swapaxes(bv_k, 0, 1).reshape(-1, plan.p)
    bd = jnp.swapaxes(bd_k, 0, 1).reshape(-1, plan.p)
    best, x, y = modes_reduce(bv, bd)

    best, x, y = jax.device_get((best, x, y))
    return StreamModesResult(
        best=best[:B], best_x=x[:B], best_y=y[:B], dirs=dirs, plan=plan,
    )


def stream_modes_best(
    result: StreamModesResult, b: int
) -> Tuple[int, int, int]:
    """(score, x, y) of pair b's best end cell (reduced on device)."""
    return (
        int(result.best[b]), int(result.best_x[b]), int(result.best_y[b])
    )
