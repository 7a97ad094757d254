"""Anti-diagonal banded fill (ops.nw_banded_diag) vs the row fill and the
oracle.  Its CUDA kernel is pinned bit for bit to the lax twin tested
here on the card (chip_smoke.py, test_cuda_fills.py)."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.config import ScoringScheme
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops.nw_banded import nw_banded_batch
from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu.ops.traceback import (
    banded_diag_fast4_traceback_pair,
)
from sequencealigning_tpu.utils.rescore import affine_rescore


def _pairs(seed, n=8, lo=3, hi=40, maxdiff=6):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        n1 = rng.randint(lo, hi)
        n2 = rng.randint(max(lo, n1 - maxdiff), n1 + maxdiff)
        out.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    return out


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("band", [4, 16])
def test_diag_finals_equal_row_kernel(compat, band):
    pairs = _pairs(11 + band, n=8)
    b = pack_batch(pairs, batch_size=8)
    row = nw_banded_batch(
        b.query, b.db, b.query_len, b.db_len, band=band,
        compat=compat, with_dirs=False,
    )
    diag = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=band,
        compat=compat, with_dirs=False,
    )
    assert np.array_equal(np.asarray(row.finals), np.asarray(diag.finals))


@pytest.mark.parametrize("compat", [True, False])
def test_diag_pallas_interpret_matches_lax(compat):
    """fast4 diag fill at a narrow band: finals equal the row fill's and
    every walked alignment rescores to its score."""
    pairs = _pairs(29, n=8)
    b = pack_batch(pairs, batch_size=8)
    lax = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=8,
        compat=compat, with_dirs="fast4", backend="lax",
    )
    row = nw_banded_batch(
        b.query, b.db, b.query_len, b.db_len, band=8,
        compat=compat, with_dirs=False,
    )
    finals = np.asarray(lax.finals)
    assert np.array_equal(np.asarray(row.finals), finals)
    dirs = np.asarray(lax.dirs)
    assert dirs.shape == (-(-2 * ((b.query.shape[1] + b.db.shape[1] + 1)
                                  // 2 + 1) // 8), 8, dirs.shape[2])
    for j, (s1, s2) in enumerate(pairs):
        score, alns = banded_diag_fast4_traceback_pair(
            dirs[:, j, :], finals[j], s1, s2, lax.k_lo_even, compat=compat
        )
        assert affine_rescore(*alns[0], ScoringScheme(), compat) == score


@pytest.mark.parametrize("compat", [True, False])
def test_diag_fast4_walker_valid_optimal(compat):
    scheme = ScoringScheme()
    pairs = _pairs(37, n=8, lo=4, hi=50, maxdiff=5)
    b = pack_batch(pairs, batch_size=8)
    res = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=16,
        compat=compat, with_dirs="fast4",
    )
    full = nw_banded_batch(
        b.query, b.db, b.query_len, b.db_len, band=16,
        compat=compat, with_dirs=False,
    )
    dirs = np.asarray(res.dirs)
    finals = np.asarray(res.finals)
    for j, (s1, s2) in enumerate(pairs):
        score, alns = banded_diag_fast4_traceback_pair(
            dirs[:, j, :], finals[j], s1, s2, res.k_lo_even, compat=compat
        )
        a1, a2 = alns[0]
        assert score == int(np.asarray(full.finals)[j].max())
        assert a1.replace("-", "").encode() == s1
        assert a2.replace("-", "").encode() == s2
        assert affine_rescore(a1, a2, scheme, compat) == score


def test_diag_band_covers_full_matrix_equals_unbanded():
    from sequencealigning_tpu.ops import oracle_gotoh

    pairs = _pairs(43, n=8, lo=3, hi=24, maxdiff=24)
    b = pack_batch(pairs, batch_size=8)
    res = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=64,
        compat=False, with_dirs=False,
    )
    for j, (s1, s2) in enumerate(pairs):
        want = oracle_gotoh.gotoh_score(s1, s2, compat=False)
        assert int(np.asarray(res.finals)[j].max()) == want


def test_diag_native_walker_matches_python():
    from sequencealigning_tpu import native
    from sequencealigning_tpu.ops.traceback import (
        banded_diag_fast4_traceback_batch,
    )

    if not native.available():
        pytest.skip("native library unavailable")
    pairs = _pairs(51, n=16, lo=4, hi=60, maxdiff=6)
    b = pack_batch(pairs, batch_size=16)
    res = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=16,
        compat=False, with_dirs="fast4",
    )
    dirs = np.asarray(res.dirs)
    finals = np.asarray(res.finals)
    batch_out = banded_diag_fast4_traceback_batch(
        dirs, finals, [p[0] for p in pairs], [p[1] for p in pairs],
        res.k_lo_even, compat=False,
    )
    for j, (s1, s2) in enumerate(pairs):
        score_py, alns_py = banded_diag_fast4_traceback_pair(
            dirs[:, j, :], finals[j], s1, s2, res.k_lo_even, compat=False
        )
        score_nat, alns_nat = batch_out[j]
        assert (score_nat, alns_nat) == (score_py, alns_py)


@pytest.mark.parametrize("compat", [True, False])
def test_diag_steady_state_body_matches_row_kernel(compat):
    """Pairs long enough that most wavefronts lie past every boundary
    cell: n1+n2 exceeds ~2L (~250 at the minimum 128-lane width)."""
    pairs = _pairs(61, n=8, lo=150, hi=180, maxdiff=8)
    b = pack_batch(pairs, batch_size=8)
    row = nw_banded_batch(
        b.query, b.db, b.query_len, b.db_len, band=12,
        compat=compat, with_dirs=False,
    )
    diag = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=12,
        compat=compat, with_dirs="fast4", backend="lax",
    )
    # The diag kernel clips its lanes to the row kernel's padded range,
    # so the two engines' finals agree EXACTLY at any requested band.
    assert np.array_equal(np.asarray(row.finals), np.asarray(diag.finals))
    dirs = np.asarray(diag.dirs)
    finals = np.asarray(diag.finals)
    scheme = ScoringScheme()
    for j, (s1, s2) in enumerate(pairs):
        want = int(finals[j].max())
        score, alns = banded_diag_fast4_traceback_pair(
            dirs[:, j, :], finals[j], s1, s2, diag.k_lo_even, compat=compat
        )
        a1, a2 = alns[0]
        assert affine_rescore(a1, a2, scheme, compat) == score == want


def test_diag_wildcard_matches_row_kernel():
    """BandedAligner runs the diag fill with wildcard=True (N matches
    anything); finals must equal the row fill's under the same flag."""
    rng = random.Random(73)
    pairs = []
    for _ in range(8):
        n1 = rng.randint(10, 50)
        mk = lambda n: bytes(rng.choice(b"ACGTN") for _ in range(n))
        pairs.append((mk(n1), mk(rng.randint(max(3, n1 - 5), n1 + 5))))
    b = pack_batch(pairs, batch_size=8)
    row = nw_banded_batch(
        b.query, b.db, b.query_len, b.db_len, band=8,
        compat=True, wildcard=True, with_dirs=False,
    )
    diag = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=8,
        compat=True, wildcard=True, with_dirs=False, backend="lax",
    )
    assert np.array_equal(np.asarray(row.finals), np.asarray(diag.finals))


@pytest.mark.parametrize("compat", [True, False])
def test_diag_full_dirs_cooptimal_matches_row_layout(compat):
    """Full 7-bit diag layout: the co-optimal enumeration (scores,
    alignments, ORDER) is identical to the row layout's -- the bytes
    encode the same cell values."""
    from sequencealigning_tpu.ops.traceback import (
        banded_diag_traceback_pair,
        banded_traceback_pair,
    )

    pairs = _pairs(83, n=8, lo=4, hi=60, maxdiff=6)
    b = pack_batch(pairs, batch_size=8)
    pal = nw_banded_diag_batch(
        b.query, b.db, b.query_len, b.db_len, band=16,
        compat=compat, with_dirs="full", backend="lax",
    )
    dp = np.asarray(pal.dirs)
    row = nw_banded_batch(
        b.query, b.db, b.query_len, b.db_len, band=16,
        compat=compat, with_dirs=True,
    )
    rdirs = np.asarray(row.dirs)
    rf = np.asarray(row.finals)
    df = np.asarray(pal.finals)
    assert np.array_equal(rf, df)
    for j, (s1, s2) in enumerate(pairs):
        want = banded_traceback_pair(
            rdirs[:, j, :], rf[j], s1, s2, row.k_lo, compat=compat,
            max_alignments=8,
        )
        got = banded_diag_traceback_pair(
            dp[:, j, :], df[j], s1, s2, pal.k_lo_even, compat=compat,
            max_alignments=8,
        )
        assert got == want
