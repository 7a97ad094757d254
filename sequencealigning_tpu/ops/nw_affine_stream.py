"""Streamed-pair batched Gotoh fill: systolic pair pipelining on the lanes.

A plain anti-diagonal sweep of one pair per row wastes ~half its lanes
on a square DP matrix: diagonal length ramps 1..min(n1,n2) and back down,
so the average valid width is ~P/2.  This fill removes that loss (the
reference aligns one pair at a time, src/main.rs:61-78): each row hosts a
*pipeline* of pairs.  A new pair is launched into the lane dimension
every S = max(L1, L2)+1 steps, so pair k's shrinking tail triangle (lanes
[d-L1, L2]) interleaves exactly with pair k+1's growing head triangle
(lanes [0, d']); the two windows tile the full lane width and never
collide because S > L1 keeps d' < d - L1.

Mechanics per step t (p = t mod S is the *younger* pair's anti-diagonal):
  * the younger pair's query char enters at lane 0 (rolling buffer s1d);
  * its db char enters at the moving column-boundary lane p -- the db
    vector s2v is *state* here, not a constant input, and each lane's db
    code flips from pair k's to pair k+1's exactly when the younger
    boundary sweeps past it (the old pair's window has already left);
  * boundary chain overrides (reference init semantics,
    needleman_wunsch_affine.rs:172-216) are applied at lanes 0 and p for
    the younger pair only; the older pair's window is interior-only by
    construction and needs none;
  * per-pair corner scores (M/I/D at (n2, n1), the reference's traceback
    seed :247-280) are captured when the *owning* pair's local diagonal
    hits n1+n2.

Direction bytes go to device memory in the packed-u32 layout of
ops.dirbits, except the byte for cell (x, y) of pair slot k lives at
word (k*S + x + y) // 4 -- a per-pair diagonal offset t0 = k*S
(ops.traceback takes it as d_offset).

Two interchangeable implementations, bit-identical:
  * gotoh_fill_stream_lax  -- jax.lax.scan reference (the CPU engine).
  * gotoh_fill_stream_cuda -- the CUDA kernel (cuda/fills.cu), GPU only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu import backend as _backend
from sequencealigning_tpu.config import NEG_INF, ScoringScheme
from sequencealigning_tpu.ops import dirbits
from sequencealigning_tpu.ops.nw_affine import _boundary_scalars, _round_up


# Widest row plan_stream lays out.  Longer db sequences take the tiled
# long-pair path (models.gotoh._long_batch).  The CUDA kernel holds at
# most backend.CUDA_MAX_LANES["stream"] of these lanes; "auto" runs wider
# rows on the lax twin.
MAX_LANES = 49_152


class StreamPlan(NamedTuple):
    """Layout of a streamed fill.  Pair b is slot (b % np_slots) of row
    (b // np_slots); its direction bytes use d_offset = slot * s."""

    n_pairs: int      # true pair count (before padding)
    np_slots: int     # pairs per row (pipeline depth)
    n_rows: int       # rows (>= n_pairs_padded / np_slots, multiple of 8)
    s: int            # launch period in steps (multiple of chunk, > L1)
    chunk: int
    n_slots_g: int    # np_slots + drain slots
    t_total: int      # total sweep steps = n_slots_g * s
    l1: int
    l2: int
    p: int            # lane width (multiple of 128, >= l2 + 2)

    def pair_coords(self, b: int) -> Tuple[int, int, int]:
        """(row, slot, d_offset) for pair b."""
        r, k = divmod(b, self.np_slots)
        return r, k, k * self.s


def plan_stream(
    n_pairs: int, l1: int, l2: int,
    chunk: int = 128, np_slots: Optional[int] = None,
) -> StreamPlan:
    if np_slots is None:
        # Deep enough to amortize the drain slot, shallow enough to keep
        # >= 8 rows.
        np_slots = max(1, min(8, n_pairs // 8))
    n_padded = _round_up(n_pairs, np_slots * 8)
    n_rows = n_padded // np_slots
    s = _round_up(max(l1, l2) + 1, chunk)
    d_total = l1 + l2 + 1
    # The last pair (slot np_slots-1) finishes at t = (np_slots-1)*s +
    # d_total - 1; round the sweep up to whole slots.
    t_need = (np_slots - 1) * s + d_total
    n_slots_g = -(-t_need // s)
    p = _round_up(l2 + 2, 128)
    if p > MAX_LANES:
        raise ValueError(
            f"pair length {l2} exceeds the streamed fill's {MAX_LANES} "
            "lanes; use nw_affine_tiled_batch (ops.nw_affine_tiled) for "
            "long pairs"
        )
    return StreamPlan(
        n_pairs=n_pairs, np_slots=np_slots, n_rows=n_rows, s=s, chunk=chunk,
        n_slots_g=n_slots_g, t_total=n_slots_g * s, l1=l1, l2=l2, p=p,
    )


class StreamResult(NamedTuple):
    finals: np.ndarray             # (B, 3) int32 -- M/I/D at (n2, n1)
    dirs: Optional[jax.Array]      # (T4, n_rows, P) uint32 or None
    plan: StreamPlan


def stream_i16_neg(scheme: ScoringScheme, plan: StreamPlan) -> Optional[int]:
    """The -inf sentinel for int16 stream state, or None if the scheme x
    shape cannot be certified to fit int16.

    int16 state halves the state bytes per lane (the lax engine's; the
    CUDA kernel is int32-only, ROADMAP S4).  Certification is closed-form:

    * every REAL DP cell is bounded below by per-consumed-char worst cost
      (a path to (x, y) consumes x+y chars at >= min(mismatch, e) each,
      plus two opens) and by the compat boundary chain o + (S+1)e;
    * the sentinel sits 64 below that, and one pre-clamp step can dip at
      most |o| + |e| + |mismatch| further -- all of which must stay above
      INT16_MIN (the per-step floor clamp in _stream_step stops any
      further decay);
    * stale (drain-window) lanes can GROW by at most match per step for S
      steps between boundary refreshes on top of the real maximum
      min(l1,l2) * match, which must stay below INT16_MAX.
    """
    o, e = scheme.gap_open, scheme.gap_extend
    mm, mt = scheme.mismatch, scheme.match_
    per_char = min(mm, e, 0)
    min_cell = (plan.l1 + plan.l2) * per_char + 2 * min(o, 0)
    chain_min = min(o, 0) + (plan.s + 1) * min(e, 0)
    neg = min(min_cell, chain_min) - 64
    dip = abs(o) + abs(e) + max(abs(mm), abs(mt))
    # Growth uses the largest POSITIVE per-step substitution: a scheme
    # with mismatch > match (CLI-expressible) grows by mismatch.
    max_cell = max(mt, mm, 0) * (min(plan.l1, plan.l2) + plan.s) + dip
    if neg - dip <= -(1 << 15) or max_cell >= (1 << 15):
        return None
    return neg


def resolve_stream_state(
    state_dtype, scheme: ScoringScheme, plan: StreamPlan, engine: str = "lax"
):
    """Map a stream-state request to a concrete dtype for ``engine``.

    "i32"/None -> int32.  "i16" -> int16 (the fill raises if the scheme x
    shape is not certified); the CUDA kernel is int32-only, so "i16"
    raises there.  "auto" -> int16 iff certified on the CPU, else int32
    (on a GPU "auto" is int32 until an int16 CUDA fill exists, ROADMAP
    S4).  A concrete dtype passes through."""
    if state_dtype in (None, "i32"):
        return jnp.int32
    if state_dtype == "auto":
        if _backend.platform() != "cpu" or stream_i16_neg(scheme, plan) is None:
            return jnp.int32
        return jnp.int16
    if state_dtype == "i16":
        state_dtype = jnp.int16
    if engine == "cuda" and jnp.dtype(state_dtype) != jnp.int32:
        raise ValueError(
            "the CUDA streamed fill keeps int32 state; int16 state runs on "
            "the lax engine only"
        )
    return state_dtype


# ---------------------------------------------------------------------------
# Shared single-step (state includes s2v; merged-roll D recurrence)
# ---------------------------------------------------------------------------


def _stream_step(
    H2, H1, M1, I1, D1, s1d, s2v,
    qc, dc, col_iota, lane_0, p,
    scheme: ScoringScheme, compat: bool, wildcard: bool,
    roll, dirs_mode,
    mode: str = "global",
    neg_sent: int = NEG_INF,
):
    """One anti-diagonal step.  qc/dc: (B, 1) younger query/db codes for
    this step.  lane_0: hoisted loop-invariant (col_iota == 0) mask.
    p: scalar, younger pair's local anti-diagonal.  dirs_mode: False/None
    (score only), "full" (7 tie bits/cell, co-optimal enumeration), or
    "fast4" (4 bits/cell: H-argmax plane code with M>I>D priority + the
    two extend flags -- exactly what a first-path walk needs).  Returns
    (M, I, D, H, s1d_new, s2v_new, byte).

    ``mode`` picks the boundary semantics at lanes 0 and p (the same hook
    as ops.nw_affine._gotoh_step): "global" = the compat/textbook gap
    chains; "semi" = free end gaps (M = 0, I = D = -inf); "local" adds
    the Smith-Waterman clamp M = max(M, 0) with restarts recorded as the
    LSTART dirs bit ("full" layout only).

    The state dtype is taken from the score buffers (int32, or int16 for
    2x VPU lane density when ``stream_i16_neg`` certifies the scheme x
    shape range).  In int16, ``neg_sent`` is the -inf sentinel and the
    accumulating I/D gap chains are floor-clamped to it each step so a
    never-refreshed lane cannot decay past INT16_MIN (the int32 sentinel
    survives S steps of decay for free; int16 does not)."""
    sdt = H2.dtype
    i16 = sdt == jnp.int16
    o = jnp.asarray(scheme.gap_open, sdt)
    e = jnp.asarray(scheme.gap_extend, sdt)
    sneg = jnp.asarray(neg_sent, sdt)

    lane_p = col_iota == p

    s1d_n = jnp.where(lane_0, qc, roll(s1d))
    s2v_n = jnp.where(lane_p, dc, s2v)

    if wildcard:
        eq = (s1d_n & s2v_n) != 0  # N-matches-anything (align.rs:298-304)
    else:
        eq = s1d_n == s2v_n
    sub = jnp.where(
        eq, jnp.asarray(scheme.match_, sdt), jnp.asarray(scheme.mismatch, sdt)
    )

    # Merged-roll Gotoh: D needs max(M,D)[x-1] so the max commutes with the
    # lane shift -- one roll instead of two (vs ops.nw_affine._gotoh_step).
    # In dirs modes the I/D maxes are written as compare+select so the
    # compares double as the extend flags (shared, not recomputed).
    t0 = M1 + o
    M = roll(H2) + sub
    restart = None
    if mode == "local":
        # int32, not bool, so it ORs straight into the dirs byte.
        restart = (M < 0).astype(jnp.int32)
        M = jnp.maximum(M, 0)
    if dirs_mode:
        ci = I1 >= t0
        cd = D1 >= t0
        D = roll(jnp.where(cd, D1, t0)) + e
        I = jnp.where(ci, I1, t0) + e
    else:
        D = roll(jnp.maximum(t0, D1)) + e
        I = jnp.maximum(t0, I1) + e
    if i16:
        # Floor the accumulating chains at the sentinel: the extend/open
        # flags above are computed pre-clamp (the clamp only binds on
        # invalid lanes, where the flags are never walked).
        I = jnp.maximum(I, sneg)
        D = jnp.maximum(D, sneg)

    if mode == "global":
        row0, col0 = _boundary_scalars(p, scheme, compat)
        if i16:
            row0 = tuple(
                jnp.maximum(v, jnp.int32(neg_sent)).astype(sdt) for v in row0
            )
            col0 = tuple(
                jnp.maximum(v, jnp.int32(neg_sent)).astype(sdt) for v in col0
            )
        M = jnp.where(lane_p, col0[0], M)
        I = jnp.where(lane_p, col0[1], I)
        D = jnp.where(lane_p, col0[2], D)
        M = jnp.where(lane_0, row0[0], M)
        # The I override at lane 0 cannot be dropped even in compat mode
        # (where row0's I is -inf): the origin's M = 0 seeds the *textbook*
        # I chain (o + p*e) through the recurrence at every slot restart.
        I = jnp.where(lane_0, row0[1], I)
        D = jnp.where(lane_0, row0[2], D)
    else:
        # Free end gaps (semi/local): boundary rows and columns hold M = 0
        # -- also the barrier that keeps the previous slot's garbage from
        # flowing into this pair's window (same role as the global chains).
        on_b = jnp.logical_or(lane_0, lane_p)
        M = jnp.where(on_b, 0, M)
        I = jnp.where(on_b, sneg, I)
        D = jnp.where(on_b, sneg, D)
        if mode == "local":
            restart = jnp.where(on_b, 1, restart)

    H = jnp.maximum(M, jnp.maximum(I, D))

    byte = None
    if dirs_mode == "full" or dirs_mode is True:
        b = (M == H).astype(jnp.int32) * dirbits.HM
        b |= (I == H).astype(jnp.int32) * dirbits.HI
        b |= (D == H).astype(jnp.int32) * dirbits.HD
        b |= ci.astype(jnp.int32) * dirbits.IEXT
        b |= (t0 >= I1).astype(jnp.int32) * dirbits.IOPEN
        dpre = cd.astype(jnp.int32) * dirbits.DEXT
        dpre |= (t0 >= D1).astype(jnp.int32) * dirbits.DOPEN
        b |= roll(dpre)
        if mode == "local":
            b |= restart * dirbits.LSTART
        byte = b
    elif dirs_mode == "fast4":
        code = jnp.where(
            M == H, 0, jnp.where(I == H, 1, 2)
        )  # argmax plane, priority M > I > D
        b = code
        b |= ci.astype(jnp.int32) * 4   # I from extend
        b |= roll(cd.astype(jnp.int32)) * 8  # D from extend
        byte = b

    return M, I, D, H, s1d_n, s2v_n, byte


# ---------------------------------------------------------------------------
# lax.scan reference implementation
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "scheme", "compat", "wildcard", "dirs_mode", "state_dtype"
    ),
)
def gotoh_fill_stream_lax(
    qstream, dstream, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    compat: bool, wildcard: bool, dirs_mode,
    state_dtype=jnp.int32,
):
    """qstream/dstream: (n_rows, t_total) int32 -- slot k's codes at
    [k*s+1, k*s+1+len); dsums/n2s: (np_slots, n_rows) int32.  Returns
    (fm, fi, fd) each (np_slots, n_rows) plus packed dirs or None."""
    R = qstream.shape[0]
    P = plan.p
    neg_sent = NEG_INF
    if state_dtype == jnp.int16:
        neg_sent = stream_i16_neg(scheme, plan)
        if neg_sent is None:
            raise ValueError("scheme x shape does not fit int16 state")
    neg = jnp.full((R, P), neg_sent, state_dtype)
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (R, P), 1)
    lane_0 = col_iota == 0
    roll = lambda a: jnp.roll(a, 1, axis=1)
    s = jnp.int32(plan.s)

    def body(carry, t):
        H2, H1, M1, I1, D1, s1d, s2v, fm, fi, fd = carry
        p = t % s
        qc = jax.lax.dynamic_slice_in_dim(qstream, t, 1, axis=1)
        dc = jax.lax.dynamic_slice_in_dim(dstream, t, 1, axis=1)
        M, I, D, H, s1d, s2v, byte = _stream_step(
            H2, H1, M1, I1, D1, s1d, s2v, qc, dc, col_iota, lane_0, p,
            scheme, compat, wildcard, roll, dirs_mode,
            neg_sent=neg_sent,
        )
        for k in range(plan.np_slots):
            cap = jnp.logical_and(
                t == k * plan.s + dsums[k][:, None],
                col_iota == n2s[k][:, None],
            )
            fm = fm.at[k].add(
                jnp.where(cap, M, 0).sum(axis=1).astype(jnp.int32)
            )
            fi = fi.at[k].add(
                jnp.where(cap, I, 0).sum(axis=1).astype(jnp.int32)
            )
            fd = fd.at[k].add(
                jnp.where(cap, D, 0).sum(axis=1).astype(jnp.int32)
            )
        out = byte.astype(jnp.uint8) if dirs_mode else jnp.zeros((), jnp.uint8)
        return (H1, H, M, I, D, s1d, s2v, fm, fi, fd), out

    zeros = jnp.zeros((R, P), jnp.int32)
    fz = jnp.zeros((plan.np_slots, R), jnp.int32)
    carry0 = (neg, neg, neg, neg, neg, zeros, zeros, fz, fz, fz)
    carry, bytes_ = jax.lax.scan(
        body, carry0, jnp.arange(plan.t_total, dtype=jnp.int32)
    )
    fm, fi, fd = carry[7:]
    if dirs_mode == "fast4":
        T8 = plan.t_total // 8
        w = bytes_.reshape(T8, 8, R, P).astype(jnp.uint32)
        dirs = w[:, 0]
        for u in range(1, 8):
            dirs = dirs | (w[:, u] << (4 * u))
    elif dirs_mode:
        T4 = plan.t_total // 4
        w = bytes_.reshape(T4, 4, R, P).astype(jnp.uint32)
        dirs = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    else:
        dirs = None
    return (fm, fi, fd), dirs


# ---------------------------------------------------------------------------
# CUDA kernel (cuda/fills.cu, stream_fill_kernel)
# ---------------------------------------------------------------------------


# Threads per block the CUDA kernel allows at 4 / 8 lanes a thread (its
# __launch_bounds__; 16 lanes a thread would spill registers).
_STREAM_MAX_THREADS = {4: 1024, 8: 512}


def stream_lanes_valid(p: int, lpt: int) -> bool:
    """Whether a P-lane row splits into whole warps of ``lpt`` lanes a
    thread within the block limit (the kernel has no dead lanes: lane 0
    reads lane P - 1, as jnp.roll does)."""
    return (
        lpt in _STREAM_MAX_THREADS
        and p % (32 * lpt) == 0
        and p // lpt <= _STREAM_MAX_THREADS[lpt]
    )


def stream_lanes_per_thread(p: int) -> int:
    """Lanes each CUDA thread holds for a P-lane row: 8 where the row
    splits into whole warps of 8 lanes, else 4 (P is a multiple of 128,
    so 4 always splits, and the kernel's lane limit keeps it within
    1024 threads)."""
    return 8 if stream_lanes_valid(p, 8) else 4


def gotoh_fill_stream_cuda(
    q_r, d_r, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    compat: bool, wildcard: bool, dirs_mode,
    lpt: Optional[int] = None,
):
    """The CUDA streamed fill, bit-identical to gotoh_fill_stream_lax.

    q_r/d_r: (n_rows, np_slots, L1|L2) char codes (pair b = slot b %
    np_slots of row b // np_slots); dsums/n2s: (np_slots, n_rows) int32.
    Returns ((fm, fi, fd) each (np_slots, n_rows) int32, dirs) with dirs
    (T8|T4, n_rows, P) uint32 in the twin's layout, or None."""
    if _backend.platform() == "gpu":
        from sequencealigning_tpu import cuda

        cuda.ensure_registered()
    R, NP, _ = q_r.shape
    P = plan.p
    mode = {None: 0, False: 0, "fast4": 1, "full": 2, True: 2}[dirs_mode]
    if lpt is None:
        lpt = stream_lanes_per_thread(P)
    if not stream_lanes_valid(P, lpt):
        raise ValueError(f"{lpt} lanes a thread cannot tile a {P}-lane row")
    upack = 8 if mode == 1 else 4
    dirs_shape = (plan.t_total // upack, R, P) if mode else (1,)
    fin, dirs = jax.ffi.ffi_call(
        "seqalign_stream_fill",
        (
            jax.ShapeDtypeStruct((3, NP, R), jnp.int32),
            jax.ShapeDtypeStruct(dirs_shape, jnp.uint32),
        ),
    )(
        q_r.astype(jnp.uint8), d_r.astype(jnp.uint8),
        dsums.astype(jnp.int32), n2s.astype(jnp.int32),
        s=np.int32(plan.s), t_total=np.int32(plan.t_total), p=np.int32(P),
        dirs_mode=np.int32(mode), compat=np.int32(compat),
        wildcard=np.int32(wildcard), lpt=np.int32(lpt),
        match=np.int32(scheme.match_), mismatch=np.int32(scheme.mismatch),
        gap_open=np.int32(scheme.gap_open),
        gap_extend=np.int32(scheme.gap_extend),
    )
    return (fin[0], fin[1], fin[2]), (dirs if mode else None)


@functools.lru_cache(maxsize=64)
def _jitted_stream_cuda(plan, scheme, compat, wildcard, dirs_mode):
    """Stream layout + CUDA fill as one jitted dispatch."""

    def run(q_all, d_all, qlen, dlen):
        R, NP = plan.n_rows, plan.np_slots
        dsums = (qlen + dlen).reshape(R, NP).T
        n2s = dlen.reshape(R, NP).T
        (fm, fi, fd), dirs = gotoh_fill_stream_cuda(
            q_all.reshape(R, NP, -1), d_all.reshape(R, NP, -1), dsums, n2s,
            plan, scheme, compat, wildcard, dirs_mode,
        )
        finals = jnp.stack(
            [fm.T.reshape(-1), fi.T.reshape(-1), fd.T.reshape(-1)], axis=1
        )
        return finals, dirs

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Host-side input prep and device-side finals assembly
# ---------------------------------------------------------------------------


def build_stream_inputs(
    query: np.ndarray, db: np.ndarray,
    query_len: np.ndarray, db_len: np.ndarray,
    plan: StreamPlan,
):
    """Lay the padded batch out as per-row code streams + per-slot capture
    params.  query/db must already be padded to plan.n_rows * plan.np_slots
    pairs.  Returns (qstream, dstream, dsums, n2s) numpy arrays."""
    NP, R, S = plan.np_slots, plan.n_rows, plan.s
    L1 = query.shape[1]
    L2 = db.shape[1]
    q_r = np.asarray(query, np.int32).reshape(R, NP, L1)
    d_r = np.asarray(db, np.int32).reshape(R, NP, L2)
    qstream = np.zeros((R, plan.t_total), np.int32)
    dstream = np.zeros((R, plan.t_total), np.int32)
    for k in range(NP):
        qstream[:, k * S + 1 : k * S + 1 + L1] = q_r[:, k]
        dstream[:, k * S + 1 : k * S + 1 + L2] = d_r[:, k]
    return (qstream, dstream) + capture_params(query_len, db_len, plan)


def capture_params(query_len, db_len, plan: StreamPlan):
    """Per-slot capture parameters (dsums, n2s), each (np_slots, n_rows)
    int32: pair (row r, slot k)'s n1 + n2 (its corner diagonal) and n2
    (its corner lane)."""
    NP, R = plan.np_slots, plan.n_rows
    qlen = np.asarray(query_len, np.int32)
    dlen = np.asarray(db_len, np.int32)
    return (
        np.ascontiguousarray((qlen + dlen).reshape(R, NP).T),
        np.ascontiguousarray(dlen.reshape(R, NP).T),
    )


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def nw_affine_stream_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs = True,
    backend: str = "auto",
    np_slots: Optional[int] = None,
    chunk: int = 128,
    state_dtype=jnp.int32,
) -> StreamResult:
    """Streamed batched Gotoh fill.  Same contract as
    ops.nw_affine.nw_affine_batch but ~2x the lane efficiency on uniform
    batches.  Pads the batch to a multiple of np_slots*8 pairs internally
    (padded lanes are stripped from finals).  backend: "auto" (the
    platform's engine for this row width, sequencealigning_tpu.backend),
    "lax" or "cuda".
    state_dtype: a dtype or "i32"/"i16"/"auto" (resolve_stream_state)."""
    B, L1 = query.shape
    _, L2 = db.shape
    plan = plan_stream(B, L1, L2, chunk=chunk, np_slots=np_slots)
    engine = _backend.engine("stream", backend, plan.p)
    state_dtype = resolve_stream_state(state_dtype, scheme, plan, engine)
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

    dirs_mode = "full" if with_dirs is True else with_dirs
    if engine == "cuda":
        fn = _jitted_stream_cuda(plan, scheme, compat, wildcard, dirs_mode)
        finals, dirs = fn(
            jnp.asarray(q_all), jnp.asarray(d_all),
            jnp.asarray(qlen), jnp.asarray(dlen),
        )
        finals = np.asarray(finals)
    else:
        qstream, dstream, dsums, n2s = build_stream_inputs(
            q_all.astype(np.int32), d_all.astype(np.int32), qlen, dlen, plan
        )
        (fm, fi, fd), dirs = gotoh_fill_stream_lax(
            jnp.asarray(qstream), jnp.asarray(dstream),
            jnp.asarray(dsums), jnp.asarray(n2s),
            plan, scheme, compat, wildcard, dirs_mode,
            state_dtype=state_dtype,
        )
        fm, fi, fd = np.asarray(fm), np.asarray(fi), np.asarray(fd)
        finals = np.stack(
            [fm.T.reshape(-1), fi.T.reshape(-1), fd.T.reshape(-1)], axis=1
        )

    return StreamResult(
        finals=np.asarray(finals)[:B].astype(np.int32), dirs=dirs, plan=plan
    )
