"""Banded affine-gap NW fill, anti-diagonal (wavefront) formulation.

The row-sweep banded kernel (ops.nw_banded) pays a log2(K)-step prefix-max
per row for the in-row I-chain.  Sweeping ANTI-diagonals a = x + y instead
makes every Gotoh dependency local:

    M(x,y) <- H(x-1,y-1) + sub      -- wavefront a-2, same diagonal k
    I(x,y) <- M/I(x,y-1) + gap      -- wavefront a-1, diagonal k-1
    D(x,y) <- M/D(x-1,y) + gap      -- wavefront a-1, diagonal k+1

so there is no scan at all -- at the cost of 2x the steps (one wavefront
holds only the cells of one diagonal-parity).  Parity packing recovers the
density: lane l holds diagonal k = k_lo_even + 2l + parity(a), so every
lane is a live cell on every step, and the k+-1 neighbours sit at lane
offsets {0, 1} that alternate with the parity (each step rolls exactly one
source pair and one character window).

Coordinates (band diagonals k = y - x in [k_lo, k_hi], k_lo_even = k_lo
rounded down to even, he = k_lo_even / 2 <= 0):

    q  = (a - par) / 2 - he         -- scalar per wavefront
    x(l) = q - l                    -- db chars consumed at lane l
    y(l) = a - x(l)

Character windows are contiguous: s1w[l] = seq1[y(l)-1] advances one lane
on odd wavefronts, s2w[l] = seq2[x(l)-1] (lane-reversed) on even ones,
each fed by one precomputed entering char per step (no gathers).

Score semantics (incl. the compat boundary-chain quirks and the swapped
row0/col0 planes, needleman_wunsch_affine.rs:172-216) are identical to
ops.nw_banded -- tests assert equal finals on shared shapes.  Two dirs
layouts (both keyed by aidx = a-1 so words align to whole chunks):
"fast4" packs 8 wavefronts of 4-bit first-path codes per word
(dirs[aidx//8, b, l], shift 4*(aidx%8)); "full" packs 4 wavefronts of the
row kernel's 7-bit co-optimal bytes (ops.dirbits codes) per word
(dirs[aidx//4, b, l], shift 8*(aidx%4)) -- cell-for-cell the same bytes
as the row layout, so co-optimal enumeration order is identical.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sequencealigning_tpu import backend as _backend
from sequencealigning_tpu.config import NEG_INF, ScoringScheme
from sequencealigning_tpu.io.encode import round_up as _round_up
from sequencealigning_tpu.ops import dirbits

NEGBIG = -(2 ** 24)  # band-mask -inf (same convention as ops.nw_banded)

def _norm_dirs(want_dirs):
    """Normalize a dirs mode to False | "fast4" | "full" (True means the
    full co-optimal layout, for parity with ops.nw_banded's bool API)."""
    if want_dirs is True:
        return "full"
    if want_dirs in (False, None):
        return False
    if want_dirs in ("fast4", "full"):
        return want_dirs
    raise ValueError(f"unknown dirs mode {want_dirs!r}")


def _upack(want_dirs) -> int:
    """Cells per packed uint32 dirs word: fast4 = 8 x 4-bit codes,
    full = 4 x 8-bit co-optimal bytes."""
    return 8 if want_dirs == "fast4" else 4


class BandedDiagResult(NamedTuple):
    finals: jax.Array  # (B, 3) M/I/D at (n2, n1)
    dirs: Optional[jax.Array]  # (Aw, B, L) uint32, _upack(mode) wavefronts/word
    k_lo_even: int
    k_lo: int


def _diag_step(
    par: int, a, M1, I1, D1, H2, H1, s1w, s2w, c1, c2,
    lane, n1v, n2v, he: int, L: int, lane_lim: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, want_dirs,
    roll, boundary: bool = True, model: str = "ref",
):
    """One wavefront (static parity `par`, traced scalar wavefront `a`).

    M1/I1/D1 = wavefront a-1 (opposite parity), H2 = H at a-2 (same
    parity), H1 = H at a-1; state shapes (B, L); c1/c2 (B, 1) entering
    chars (c1 consumed when par==1, c2 when par==0).  Returns
    (M, I, D, H, s1w', s2w', code).

    model selects the gap-open source: "ref" opens I/D from the M plane
    only (the reference's Gotoh, needleman_wunsch_affine.rs:87-94);
    "std" opens from H = max(M, I, D) -- the STANDARD gap-affine model,
    the one WFA's merged M-wavefront implements (wfa.rs:353-398).  The
    two coincide iff mismatch <= 2*gap_extend in penalty terms
    (PARITY.md); "std" is what lets the banded kernel serve as the WFA
    certificate engine for arbitrary penalty schemes.  H1 is unused
    (dead arg, pruned by XLA) under "ref".

    boundary=False is the steady-state variant for wavefronts past every
    x=0 / y=0 cell (a > max(2L + k_lo_even - 1, 2 - k_lo_even)): the
    row0/col0 chain selects and the x>=1 / y>=1 clamps are dropped (only
    the upper rectangle bounds remain -- dependencies are non-decreasing
    in x and y, so over-the-corner cells can never flow back into a
    pair's rectangle or its capture mask).
    """
    o = jnp.int32(scheme.gap_open)
    e = jnp.int32(scheme.gap_extend)
    neg = jnp.int32(NEG_INF)
    lane_0 = lane == 0
    lane_last = lane == L - 1

    if par == 1:
        s1w = jnp.where(lane_last, c1, roll(s1w, -1))
    else:
        s2w = jnp.where(lane_0, c2, roll(s2w, 1))

    q = (a - par) // 2 - he
    xv = q - lane
    yv = a - xv

    if wildcard:
        eq = (s1w & s2w) != 0  # N-matches-anything (align.rs:298-304)
    else:
        eq = s1w == s2w
    sub = jnp.where(eq, jnp.int32(scheme.match_), jnp.int32(scheme.mismatch))

    M = H2 + sub

    # Gap-open source: the M plane ("ref") or the full H ("std").
    M1o = (H1 if model == "std" else M1) + o
    if par == 0:
        # I reads lane l-1 of a-1; D reads lane l.
        I_src_i = jnp.where(lane_0, NEGBIG, roll(I1, 1))
        I = jnp.maximum(jnp.where(lane_0, NEGBIG, roll(M1o, 1)), I_src_i) + e
        D_src_d = D1
        D = jnp.maximum(M1o, D_src_d) + e
    else:
        # I reads lane l; D reads lane l+1.
        I_src_i = I1
        I = jnp.maximum(M1o, I_src_i) + e
        D_src_d = jnp.where(lane_last, NEGBIG, roll(D1, -1))
        D = jnp.maximum(jnp.where(lane_last, NEGBIG, roll(M1o, -1)),
                        D_src_d) + e

    # Effective-band clip: lanes with diagonal k > k_hi_eff are masked so
    # the effective band matches the row kernel's padded range exactly
    # (static per-parity limit; keeps fast4/full model modes consistent).
    lane_ok = lane <= lane_lim
    if boundary:
        valid = jnp.logical_and(
            jnp.logical_and(
                jnp.logical_and(xv >= 1, xv <= n2v), lane_ok
            ),
            jnp.logical_and(yv >= 1, yv <= n1v),
        )
    else:
        valid = jnp.logical_and(
            jnp.logical_and(xv <= n2v, yv <= n1v), lane_ok
        )
    M = jnp.where(valid, M, NEGBIG)
    I = jnp.where(valid, I, NEGBIG)
    D = jnp.where(valid, D, NEGBIG)

    if boundary:
        # Boundary cells (same value conventions as ops.nw_banded: compat
        # stores the x=0 chain in D and the y=0 chain in I with one extra
        # extension, the reference's quirk; textbook uses I / D).
        row0 = jnp.logical_and(xv == 0, jnp.logical_and(yv >= 0, yv <= n1v))
        col0 = jnp.logical_and(yv == 0, jnp.logical_and(xv >= 1, xv <= n2v))
        if compat:
            row0_i, row0_d = neg, o + (yv + 1) * e
            col0_i, col0_d = o + (xv + 1) * e, neg
        else:
            row0_i, row0_d = o + yv * e, neg
            col0_i, col0_d = neg, o + xv * e
        origin = jnp.logical_and(row0, yv == 0)
        M = jnp.where(row0, jnp.where(origin, 0, neg), M)
        I = jnp.where(row0, jnp.where(origin, neg, row0_i), I)
        D = jnp.where(row0, jnp.where(origin, neg, row0_d), D)
        M = jnp.where(col0, neg, M)
        I = jnp.where(col0, col0_i, I)
        D = jnp.where(col0, col0_d, D)

    H = jnp.maximum(M, jnp.maximum(I, D))

    code = None
    if want_dirs == "fast4":
        # fast4: bits[0:2] H-argmax plane (M > I > D), bit2 I-extend,
        # bit3 D-extend -- extend flags against the a-1 sources.
        code = jnp.where(M == H, 0, jnp.where(I == H, 1, 2))
        code |= (I == I_src_i + e).astype(jnp.int32) * 4
        code |= (D == D_src_d + e).astype(jnp.int32) * 8
    elif want_dirs == "full":
        # full 7-bit co-optimal layout (ops.dirbits codes): all H tie
        # bits + both parent bits per gap plane.  Values match the row
        # kernel's cell-for-cell, so the co-optimal enumeration order is
        # bit-identical.
        if par == 0:
            M_src_i = jnp.where(lane_0, NEGBIG, roll(M1o, 1))
            M_src_d = M1o
        else:
            M_src_i = M1o
            M_src_d = jnp.where(lane_last, NEGBIG, roll(M1o, -1))
        code = (M == H).astype(jnp.int32) * dirbits.HM
        code |= (I == H).astype(jnp.int32) * dirbits.HI
        code |= (D == H).astype(jnp.int32) * dirbits.HD
        code |= (I == I_src_i + e).astype(jnp.int32) * dirbits.IEXT
        code |= (I == M_src_i + e).astype(jnp.int32) * dirbits.IOPEN
        code |= (D == D_src_d + e).astype(jnp.int32) * dirbits.DEXT
        code |= (D == M_src_d + e).astype(jnp.int32) * dirbits.DOPEN
    return M, I, D, H, s1w, s2w, code


def _init_state(seq1, seq2, he: int, L: int):
    """Wavefront-0 state: windows positioned for a=0 and the origin cell
    (0,0) at lane -he.  Sequences (B, Ln) int32; -1 padding chars."""
    B = seq1.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    # s1w0[l] = seq1[l + he - 1]
    pad1l = max(0, 1 - he)
    pad1r = max(0, (L - 1 + he - 1) - (seq1.shape[1] - 1))
    s1p = jnp.pad(seq1, ((0, 0), (pad1l, pad1r)), constant_values=-1)
    s1w0 = jax.lax.slice_in_dim(
        s1p, pad1l + he - 1, pad1l + he - 1 + L, axis=1
    )
    # s2w0[l] = seq2[-he - l - 1] (lane-reversed window)
    pad2l = max(0, L + he)          # lowest index: -he - L
    pad2r = max(0, -he)             # highest index: -he - 1
    s2p = jnp.pad(seq2, ((0, 0), (pad2l, pad2r)), constant_values=-1)
    lo = pad2l + (-he - L)          # index of l = L-1
    s2w0 = jax.lax.slice_in_dim(s2p, lo, lo + L, axis=1)[:, ::-1]
    m0 = jnp.where(lane == -he, 0, NEGBIG)
    negs = jnp.full((B, L), NEGBIG, jnp.int32)
    return lane, s1w0, s2w0, m0, negs


def _entering_streams(seq1, seq2, he: int, L: int, n_iters: int):
    """c1s[:, i] = seq1[i + he + L - 1] (enters s1w at a = 2i+1);
    c2s[:, i] = seq2[i - he] (enters s2w at a = 2i+2).  -1 padding."""
    start1 = he + L - 1
    pad1l = max(0, -start1)
    pad1r = max(0, start1 + n_iters - seq1.shape[1])
    s1p = jnp.pad(seq1, ((0, 0), (pad1l, pad1r)), constant_values=-1)
    c1s = jax.lax.slice_in_dim(
        s1p, pad1l + start1, pad1l + start1 + n_iters, axis=1
    )
    start2 = -he
    pad2r = max(0, start2 + n_iters - seq2.shape[1])
    s2p = jnp.pad(seq2, ((0, 0), (0, pad2r)), constant_values=-1)
    c2s = jax.lax.slice_in_dim(s2p, start2, start2 + n_iters, axis=1)
    return c1s, c2s


def _banded_diag_lax(
    seq1, seq2, n1v, n2v, k_lo_even: int, L: int, n_iters: int,
    k_hi_eff: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, want_dirs,
    model: str = "ref",
):
    """lax.scan reference: one iteration = wavefronts (2i+1, 2i+2)."""
    want_dirs = _norm_dirs(want_dirs)
    B = seq1.shape[0]
    he = k_lo_even // 2
    q32 = seq1.astype(jnp.int32)
    d32 = seq2.astype(jnp.int32)
    lane, s1w0, s2w0, m0, negs = _init_state(q32, d32, he, L)
    c1s, c2s = _entering_streams(q32, d32, he, L, n_iters)
    roll = lambda v, s: jnp.roll(v, s, axis=1)

    def capture(cap, a, M, I, D):
        q0 = (a - (a % 2)) // 2 - he
        xv = q0 - lane
        yv = a - xv
        hit = jnp.logical_and(xv == n2v, yv == n1v)
        capM, capI, capD = cap
        return (
            capM + jnp.where(hit, M, 0).sum(1, keepdims=True),
            capI + jnp.where(hit, I, 0).sum(1, keepdims=True),
            capD + jnp.where(hit, D, 0).sum(1, keepdims=True),
        )

    def body(carry, ins):
        (M1, I1, D1, H1, H2, s1w, s2w, cap) = carry
        i, c1, c2 = ins
        lim = lambda par: (k_hi_eff - k_lo_even - par) // 2
        a1 = 2 * i + 1
        M, I, D, H, s1w, s2w, code1 = _diag_step(
            1, a1, M1, I1, D1, H2, H1, s1w, s2w, c1[:, None], None,
            lane, n1v, n2v, he, L, lim(1), scheme, compat, wildcard,
            want_dirs, roll, model=model,
        )
        cap = capture(cap, a1, M, I, D)
        a2 = 2 * i + 2
        M2, I2, D2, Hb, s1w, s2w, code2 = _diag_step(
            0, a2, M, I, D, H1, H, s1w, s2w, None, c2[:, None],
            lane, n1v, n2v, he, L, lim(0), scheme, compat, wildcard,
            want_dirs, roll, model=model,
        )
        cap = capture(cap, a2, M2, I2, D2)
        out = (code1, code2) if want_dirs else 0
        return (M2, I2, D2, Hb, H, s1w, s2w, cap), out

    zero = jnp.zeros((B, 1), jnp.int32)
    init = (m0, negs, negs, m0, negs, s1w0, s2w0, (zero, zero, zero))
    (_, _, _, _, _, _, _, cap), codes = jax.lax.scan(
        body, init,
        (jnp.arange(n_iters, dtype=jnp.int32),
         jnp.swapaxes(c1s, 0, 1), jnp.swapaxes(c2s, 0, 1)),
    )
    finals = jnp.concatenate(cap, axis=1)
    dirs = None
    if want_dirs:
        # aidx = a-1: iteration i emits aidx 2i (code1) and 2i+1 (code2).
        upack = _upack(want_dirs)
        bits = 32 // upack
        c1, c2 = codes
        A2 = jnp.stack([c1, c2], axis=1).reshape(2 * n_iters, B, L)
        Ap = _round_up(A2.shape[0], upack)
        A2 = jnp.pad(A2, ((0, Ap - A2.shape[0]), (0, 0), (0, 0)))
        w = A2.reshape(Ap // upack, upack, B, L).astype(jnp.uint32)
        shifts = (
            bits * jnp.arange(upack, dtype=jnp.uint32)
        )[None, :, None, None]
        dirs = (w << shifts).sum(axis=1, dtype=jnp.uint32)
    return finals, dirs


# ---------------------------------------------------------------------------
# CUDA kernel (cuda/fills.cu, banded_fill_kernel)
# ---------------------------------------------------------------------------

def banded_lanes_per_thread(L: int) -> int:
    """Lanes each CUDA thread holds: 4 up to 4096 lanes (1024 threads),
    then 16.  At config 4's 256 lanes, 4 lanes a thread (two warps per
    pair) beat 8 (one warp, no block barrier) and 16 (PERF.md)."""
    return 4 if L <= 4096 else 16


def banded_diag_fill_cuda(
    query, db, n1v, n2v,
    k_lo_even: int, L: int, n_iters: int, k_hi_eff: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, want_dirs,
    model: str = "ref", lpt: Optional[int] = None,
):
    """The CUDA banded fill, bit-identical to _banded_diag_lax: query/db
    (B, L1|L2) char codes, n1v/n2v (B,) or (B, 1) true lengths.  Returns
    ((B, 3) finals, dirs (Aw, B, L) uint32 or None)."""
    want_dirs = _norm_dirs(want_dirs)
    _backend.engine("banded_diag", "cuda", L)  # raises past the lane limit
    if _backend.platform() == "gpu":
        from sequencealigning_tpu import cuda

        cuda.ensure_registered()
    B = query.shape[0]
    mode = {False: 0, "fast4": 1, "full": 2}[want_dirs]
    upack = _upack(want_dirs)
    aw = -(-2 * n_iters // upack)
    if lpt is None:
        lpt = banded_lanes_per_thread(L)
    fin, dirs = jax.ffi.ffi_call(
        "seqalign_banded_fill",
        (
            jax.ShapeDtypeStruct((B, 3), jnp.int32),
            jax.ShapeDtypeStruct((aw, B, L) if mode else (1,), jnp.uint32),
        ),
    )(
        query.astype(jnp.int8), db.astype(jnp.int8),
        n1v.reshape(B).astype(jnp.int32), n2v.reshape(B).astype(jnp.int32),
        lanes=np.int32(L), n_iters=np.int32(n_iters),
        k_lo_even=np.int32(k_lo_even), k_hi_eff=np.int32(k_hi_eff),
        aw=np.int32(aw), dirs_mode=np.int32(mode),
        compat=np.int32(compat), wildcard=np.int32(wildcard),
        std_model=np.int32(model == "std"), lpt=np.int32(lpt),
        match=np.int32(scheme.match_), mismatch=np.int32(scheme.mismatch),
        gap_open=np.int32(scheme.gap_open),
        gap_extend=np.int32(scheme.gap_extend),
    )
    return fin, (dirs if mode else None)


@functools.lru_cache(maxsize=64)
def _jitted_diag(engine, k_lo_even, L, n_iters, k_hi_eff, scheme,
                 compat, wildcard, want_dirs, model="ref"):
    """One jitted dispatch per configuration."""

    def run(query, db, n1v, n2v):
        fill = banded_diag_fill_cuda if engine == "cuda" else _banded_diag_lax
        return fill(
            query, db, n1v, n2v, k_lo_even, L, n_iters, k_hi_eff,
            scheme, compat, wildcard, want_dirs, model=model,
        )

    return jax.jit(run)


def nw_banded_diag_batch(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    band: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs=False,
    backend: str = "auto",
    model: str = "ref",
) -> BandedDiagResult:
    """Anti-diagonal banded Gotoh fill.  Same band semantics and score
    contract as ops.nw_banded.nw_banded_batch; with_dirs in (False,
    "fast4", "full"/True).  backend: "auto" (the platform's engine for
    this band width, sequencealigning_tpu.backend), "lax" or "cuda".

    model="std" switches the gap-open source from the M plane to
    H = max(M, I, D) -- the standard gap-affine model (what WFA's merged
    M-wavefront computes, wfa.rs:353-398), enabling the WFA certificate
    route for penalty schemes outside the coincidence regime
    (mismatch > 2*gap_extend, PARITY.md).  Textbook boundaries and fast4
    dirs only: the "full" 7-bit co-optimal layout and the compat
    boundary quirks are reference-model artifacts."""
    if with_dirs is True:
        with_dirs = "full"
    if with_dirs not in (False, None, "fast4", "full"):
        raise ValueError(f"unknown dirs mode {with_dirs!r}")
    if model not in ("ref", "std"):
        raise ValueError(f"unknown affine model {model!r}")
    if model == "std" and (compat or with_dirs == "full"):
        raise ValueError(
            "model='std' (any-state gap opens) supports textbook "
            "boundaries and fast4/score-only dirs; compat and the full "
            "co-optimal layout are reference-model semantics"
        )
    qlen = np.asarray(query_len)
    dlen = np.asarray(db_len)
    diff = qlen.astype(np.int64) - dlen.astype(np.int64)
    k_lo = int(min(0, diff.min()) - band)
    k_hi = int(max(0, diff.max()) + band)
    k_lo_even = k_lo - (k_lo & 1)
    L = _round_up((k_hi - k_lo_even + 2) // 2, 128)
    # Effective band = the ROW kernel's padded range (k_lo .. k_lo+K-1,
    # K = round_up(span, 128)) so every banded engine reports identical
    # scores for the same requested band: diag lanes beyond it are masked,
    # and L grows one block in the rare corner where the diag span would
    # fall short of the row padding (odd k_lo, span mod 256 near 0).
    k_hi_eff = k_lo + _round_up(k_hi - k_lo + 1, 128) - 1
    if k_lo_even + 2 * L - 1 < k_hi_eff:
        L += 128
    _, L1 = query.shape
    _, L2 = db.shape
    want_dirs = with_dirs if with_dirs in ("fast4", "full") else False
    engine = _backend.engine("banded_diag", backend, L)
    n_iters = (L1 + L2 + 1) // 2 + 1

    fn = _jitted_diag(
        engine, k_lo_even, L, n_iters, k_hi_eff, scheme, compat,
        wildcard, want_dirs, model=model,
    )
    finals, dirs = fn(
        jnp.asarray(np.asarray(query, np.int8)),
        jnp.asarray(np.asarray(db, np.int8)),
        jnp.asarray(qlen, jnp.int32)[:, None],
        jnp.asarray(dlen, jnp.int32)[:, None],
    )
    return BandedDiagResult(
        finals=finals, dirs=dirs, k_lo_even=k_lo_even, k_lo=k_lo
    )
