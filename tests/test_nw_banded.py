"""Banded affine-NW tests: wide band == full Gotoh; narrow band contract."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.errors import AlignmentError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.ops.nw_banded import nw_banded_batch
from sequencealigning_tpu.ops.traceback import banded_traceback_pair


def _pairs(seed, n=8, lo=2, hi=28, maxdiff=6):
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
def test_wide_band_equals_full_gotoh(compat):
    pairs = _pairs(41)
    batch = pack_batch(pairs, batch_size=8)
    r = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=64, compat=compat,
    )
    finals = np.asarray(r.finals)
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in finals[b]) == exp, (b, s1, s2)


@pytest.mark.parametrize("compat", [True, False])
def test_wide_band_traceback_matches_oracle(compat):
    pairs = _pairs(43, n=6, hi=18)
    batch = pack_batch(pairs, batch_size=8)
    r = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=48, compat=compat,
    )
    dirs = np.asarray(r.dirs)
    finals = np.asarray(r.finals)
    for b, (s1, s2) in enumerate(pairs):
        try:
            exp = oracle_gotoh.gotoh_traceback_all(s1, s2, compat=compat)
        except AlignmentError:
            exp = "ERR"
        try:
            got = banded_traceback_pair(
                dirs[:, b, :], finals[b], s1, s2, r.k_lo, compat=compat
            )
        except AlignmentError:
            got = "ERR"
        assert exp == got, (b, s1, s2)


def test_narrow_band_restricts_gaps():
    """A long indel outside the band must not be found; the banded score is
    the in-band optimum (here: mismatches instead of a 6-gap)."""
    s1 = b"AAAAAAACCCCCCCCCCCCCCCC"
    s2 = b"ACCCCCCCCCCCCCCCC"  # needs a 6-long leading query gap
    batch = pack_batch([(s1, s2)], batch_size=8)
    full = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=32
    )
    narrow = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=2
    )
    full_score = int(np.asarray(full.finals)[0].max())
    narrow_score = int(np.asarray(narrow.finals)[0].max())
    assert full_score == oracle_gotoh.gotoh_score(s1, s2)
    assert narrow_score <= full_score


def test_wildcard_band():
    batch = pack_batch([(b"NNNN", b"ACGT")], batch_size=8)
    r = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=8, wildcard=True,
    )
    assert int(np.asarray(r.finals)[0].max()) == 20


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("with_dirs", [True, False])
def test_pallas_matches_lax(compat, with_dirs):
    """At the removed kernel test's shapes: the band-16 row fill equals the
    diag fill (the production banded engine) in finals, and with dirs
    the co-optimal walk reproduces sequences at the banded score."""
    from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch

    pairs = _pairs(47, n=8, lo=2, hi=40, maxdiff=8)
    batch = pack_batch(pairs, batch_size=8)
    kw = dict(band=16, compat=compat, with_dirs=with_dirs)
    r_lax = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        **kw,
    )
    r_diag = nw_banded_diag_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=16, compat=compat, with_dirs=False,
    )
    finals = np.asarray(r_lax.finals)
    assert np.array_equal(finals, np.asarray(r_diag.finals))
    if with_dirs:
        dirs = np.asarray(r_lax.dirs)
        for b, (s1, s2) in enumerate(pairs):
            try:
                score, alns = banded_traceback_pair(
                    dirs[:, b, :], finals[b], s1, s2, r_lax.k_lo,
                    compat=compat,
                )
            except AlignmentError:
                continue
            assert score == int(finals[b].max())
            for a1, a2 in alns:
                assert a1.replace("-", "").encode() == s1
                assert a2.replace("-", "").encode() == s2


def test_pallas_traceback_matches_oracle():
    pairs = _pairs(53, n=8, hi=20)
    batch = pack_batch(pairs, batch_size=8)
    r = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=48, compat=True,
    )
    dirs = np.asarray(r.dirs)
    finals = np.asarray(r.finals)
    for b, (s1, s2) in enumerate(pairs):
        exp = oracle_gotoh.gotoh_traceback_all(s1, s2, compat=True)
        got = banded_traceback_pair(
            dirs[:, b, :], finals[b], s1, s2, r.k_lo, compat=True
        )
        assert exp == got, (b, s1, s2)


def test_fast4_pallas_matches_lax_and_oracle():
    from sequencealigning_tpu.ops.traceback import banded_fast4_traceback_pair

    pairs = _pairs(59, n=8, lo=2, hi=40, maxdiff=6)
    batch = pack_batch(pairs, batch_size=8)
    kw = dict(band=32, compat=True, with_dirs="fast4")
    rp = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        **kw,
    )
    x_rows = batch.db.shape[1] + 1
    assert np.asarray(rp.dirs).shape[0] == -(-x_rows // 8)

    # The fast4 walk must reproduce an optimal-scoring alignment.
    dirs = np.asarray(rp.dirs)
    finals = np.asarray(rp.finals)
    from sequencealigning_tpu.ops import oracle_gotoh

    for b, (s1, s2) in enumerate(pairs):
        score, alns = banded_fast4_traceback_pair(
            dirs[:, b, :], finals[b], s1, s2, rp.k_lo, compat=True
        )
        assert score == oracle_gotoh.gotoh_score(s1, s2), (b, s1, s2)
        a1, a2 = alns[0]
        # Re-score the walked alignment.
        from sequencealigning_tpu.config import ScoringScheme

        sch = ScoringScheme()
        got, gap = 0, None
        for c1, c2 in zip(a1, a2):
            if c1 == "-" or c2 == "-":
                which = "q" if c1 == "-" else "d"
                got += sch.gap_extend + (sch.gap_open if gap != which else 0)
                gap = which
            else:
                got += sch.match_ if c1 == c2 else sch.mismatch
                gap = None
        # compat boundary chains add one extra extension per leading /
        # trailing full-gap run; interior alignments rescore exactly.
        assert got in (score, score - sch.gap_extend, score - 2 * sch.gap_extend), (
            b, got, score, a1, a2,
        )


def test_banded_model_first_only_fast4():
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner

    al = get_aligner(
        AlignConfig(algo=Algo.BANDED, band=16, first_only=True)
    )
    for s1, s2 in _pairs(71, n=4, hi=24):
        r = al.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
        assert r.ok, r.error
        assert r.score == oracle_gotoh.gotoh_score(s1, s2)
        assert r.aligned_query.replace("-", "").encode() == s1
        assert r.aligned_db.replace("-", "").encode() == s2


@pytest.mark.parametrize("band", [16, 24])
def test_band_narrower_than_length_matches_oracle(band):
    """Regression: the top band lane's rolling-window char was off by one;
    it only matters when the valid region reaches the padded top lanes
    (n1 > k_hi + K-padding), i.e. bands much narrower than the length."""
    rng = random.Random(97)
    n = 220
    pairs = []
    for _ in range(4):
        s1 = bytes(rng.choice(b"ACGT") for _ in range(n))
        s2l = bytearray(s1)
        for _ in range(4):
            p = rng.randrange(n)
            s2l[p] = rng.choice([c for c in b"ACGT" if c != s2l[p]])
        pairs.append((s1, bytes(s2l)))
    batch = pack_batch(pairs, batch_size=8)
    r = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=band, with_dirs=False,
    )
    f = np.asarray(r.finals)
    for b, (s1, s2) in enumerate(pairs):
        assert int(f[b].max()) == oracle_gotoh.gotoh_score(s1, s2), b
