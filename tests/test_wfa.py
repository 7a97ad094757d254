"""Batched textbook-WFA tests vs the scalar oracle."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.config import WfaPenalties
from sequencealigning_tpu.errors import AlignmentError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops.oracle_wfa import wfa_textbook_score
from sequencealigning_tpu.ops.wfa import wfa_textbook_batch, wfa_traceback_host


def _penalty_of(a1, a2, p=WfaPenalties()):
    pen, st = 0, "M"
    for c1, c2 in zip(a1, a2):
        if c1 == "-":
            pen += p.gap_extend if st == "D" else p.gap_open + p.gap_extend
            st = "D"
        elif c2 == "-":
            pen += p.gap_extend if st == "I" else p.gap_open + p.gap_extend
            st = "I"
        else:
            pen += 0 if c1 == c2 else p.mismatch
            st = "M"
    return pen


def _random_pairs(seed, n=8, lo=3, hi=30, maxdiff=5):
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


def test_scores_match_oracle():
    pairs = _random_pairs(47)
    batch = pack_batch(pairs, batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=32, s_max=256,
    )
    for b, (s1, s2) in enumerate(pairs):
        assert bool(np.asarray(res.converged)[b])
        assert int(np.asarray(res.score)[b]) == wfa_textbook_score(s1, s2)


def test_traceback_reconstructs_sequences_and_penalty():
    pairs = _random_pairs(53)
    batch = pack_batch(pairs, batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=32, s_max=256,
    )
    for b, (s1, s2) in enumerate(pairs):
        p, a1, a2 = wfa_traceback_host(res, b, s1, s2)
        assert a1.replace("-", "") == s1.decode()
        assert a2.replace("-", "") == s2.decode()
        assert _penalty_of(a1, a2) == p


def test_identical_pair_penalty_zero():
    batch = pack_batch([(b"ACGTACGTAC", b"ACGTACGTAC")], batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=16, s_max=64,
    )
    assert int(np.asarray(res.score)[0]) == 0
    p, a1, a2 = wfa_traceback_host(res, 0, b"ACGTACGTAC", b"ACGTACGTAC")
    assert (a1, a2) == ("ACGTACGTAC", "ACGTACGTAC")


def test_low_divergence_1kb_read():
    rng = random.Random(59)
    ref = bytes(rng.choice(b"ACGT") for _ in range(1000))
    mut = bytearray(ref)
    for _ in range(8):
        pos = rng.randrange(len(mut))
        mut[pos] = rng.choice([c for c in b"ACGT" if c != mut[pos]])
    del mut[500:503]  # one 3-long deletion
    pair = (bytes(mut), ref)
    batch = pack_batch([pair], batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=16, s_max=128,
    )
    assert bool(np.asarray(res.converged)[0])
    p, a1, a2 = wfa_traceback_host(res, 0, *pair)
    assert _penalty_of(a1, a2) == p
    assert a1.replace("-", "") == pair[0].decode()
    # <= 8 mismatches * 4 + one gap (2 + 3*6) = 52
    assert p <= 52


def test_band_escape_reports_nonconvergence():
    """A pair needing a 40-long gap cannot converge in an 8-wide band."""
    s1 = b"A" * 50
    s2 = b"A" * 10
    batch = pack_batch([(s1, s2)], batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=8, s_max=64,
    )
    # band construction includes the length difference, so this converges;
    # force escape with equal-length but indel-heavy content instead:
    s1 = b"ACGT" * 10 + b"T" * 40
    s2 = b"T" * 40 + b"ACGT" * 10
    batch = pack_batch([(s1, s2)], batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=4, s_max=700,
    )
    if bool(np.asarray(res.converged)[0]):
        # in-band optimum is all-mismatch-ish; just assert traceback sanity
        p, a1, a2 = wfa_traceback_host(res, 0, s1, s2)
        assert _penalty_of(a1, a2) == p
    else:
        with pytest.raises(AlignmentError):
            wfa_traceback_host(res, 0, s1, s2)


def test_textbook_band_escape_recovers_with_alignment():
    """A pair whose optimum leaves the initial band must come back with
    BOTH the exact penalty and an alignment (round-1 gap: escape returned
    score-only)."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops import oracle_wfa

    # 40-long indel escapes band 8, converges at 16+ after doubling.
    s1 = b"ACGT" * 30
    s2 = b"ACGT" * 10 + b"ACGT" * 30
    al = get_aligner(AlignConfig(algo=Algo.WFA, compat=False, band=8))
    r = al.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
    assert r.ok, r.error
    assert r.score == oracle_wfa.wfa_textbook_score(s1, s2)
    assert r.aligned_query is not None
    assert r.aligned_query.replace("-", "").encode() == s1
    assert r.aligned_db.replace("-", "").encode() == s2


def test_textbook_gotoh_fallback_beyond_max_band(monkeypatch):
    """Escapes beyond the doubling cap fall to the exact penalty-converted
    Gotoh engine -- still exact, still with an alignment."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.models.wfa import WfaAligner
    from sequencealigning_tpu.ops import oracle_wfa

    monkeypatch.setattr(WfaAligner, "wfa_max_band", 4)
    monkeypatch.setattr(WfaAligner, "wfa_banded_max_band", 4)
    s1 = b"TTTT" * 20
    s2 = b"ACGTACGTACGT" * 5 + b"TTTT" * 20   # needs a 60-long gap
    al = get_aligner(AlignConfig(algo=Algo.WFA, compat=False, band=2))
    r = al.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
    assert r.ok, r.error
    assert r.score == oracle_wfa.wfa_textbook_score(s1, s2)
    assert r.aligned_query is not None
    assert r.aligned_query.replace("-", "").encode() == s1
    assert r.aligned_db.replace("-", "").encode() == s2


def test_textbook_converges_beyond_old_s_max_ceiling():
    """The ring-buffer fill has no score-sized allocation: a pair needing
    s > 512 (the old default ceiling) converges on-device."""
    import random

    from sequencealigning_tpu.ops.wfa import wfa_textbook_batch, wfa_traceback_host
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops import oracle_wfa

    rng = random.Random(71)
    n = 400
    s1l = [rng.choice("ACGT") for _ in range(n)]
    s2l = list(s1l)
    for i in range(0, n, 2):  # 50% divergence: s ~ 200 * 4 = 800
        s2l[i] = rng.choice("ACGT")
    s1 = "".join(s1l).encode()
    s2 = "".join(s2l).encode()
    batch = pack_batch([(s1, s2)], batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=32
    )
    assert bool(res.converged[0])
    score, a1, a2 = wfa_traceback_host(res, 0, s1, s2)
    assert score == oracle_wfa.wfa_textbook_score(s1, s2)
    assert score > 512  # genuinely beyond the old ceiling
    assert a1.replace("-", "").encode() == s1


def test_banded_route_matches_wavefront_engine():
    """The in-regime banded-Gotoh route (wfa_engine default 'auto') returns
    the same exact penalties as the wavefront engine, with valid
    alignments (ties may legitimately pick a different optimal path)."""
    import dataclasses

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.models.wfa import WfaAligner
    from sequencealigning_tpu.ops import oracle_wfa

    cfg_b = AlignConfig(algo=Algo.WFA, compat=False, band=16)
    cfg_w = dataclasses.replace(cfg_b, wfa_engine="wavefront")
    al_b = get_aligner(cfg_b)
    al_w = get_aligner(cfg_w)
    assert isinstance(al_b, WfaAligner)
    pairs = _random_pairs(91, n=6, lo=5, hi=60, maxdiff=8)
    pairs += [(b"", b"ACGT"), (b"ACGTA", b""), (b"", b"")]
    for s1, s2 in pairs:
        rb = al_b.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
        rw = al_w.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
        assert rb.ok and rw.ok, (rb, rw)
        want = oracle_wfa.wfa_textbook_score(s1, s2)
        assert rb.score == want
        assert rw.score == want
        for r in (rb, rw):
            assert r.aligned_query.replace("-", "").encode() == s1
            assert r.aligned_db.replace("-", "").encode() == s2
            assert _penalty_of(r.aligned_query, r.aligned_db) == want


def test_out_of_regime_scheme_routes_to_wavefront():
    """mismatch > 2*gap_extend breaks the merged-M / M-only-opens model
    coincidence (PARITY.md); auto must use the wavefront engine and still
    match the WFA-model oracle."""
    from sequencealigning_tpu.config import AlignConfig, Algo, WfaPenalties
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops import oracle_wfa

    pen = WfaPenalties(mismatch=9, gap_open=1, gap_extend=2)
    cfg = AlignConfig(algo=Algo.WFA, compat=False, band=16, wfa_penalties=pen)
    al = get_aligner(cfg)
    for s1, s2 in _random_pairs(17, n=5, lo=4, hi=40, maxdiff=6):
        r = al.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
        assert r.ok, r.error
        assert r.score == oracle_wfa.wfa_textbook_score(s1, s2, pen)
        assert _penalty_of(r.aligned_query, r.aligned_db, pen) == r.score


@pytest.mark.tier2  # multi-minute sweep; quick loop: -m 'not tier2'
def test_native_engine_matches_wavefront_engine_bytes():
    """The native exact engine shares the traceback walker's tie logic with
    the device wavefront engine; at a band wide enough to never clip, the two
    must produce byte-identical alignments and equal penalties."""
    from sequencealigning_tpu import native
    from sequencealigning_tpu.ops import oracle_wfa

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    pairs = _random_pairs(23, n=10, lo=4, hi=48, maxdiff=10)
    pairs += [(b"", b"ACGT"), (b"ACGTA", b""), (b"", b""), (b"ACGT", b"ACGT")]
    for pen in (
        WfaPenalties(),
        WfaPenalties(mismatch=9, gap_open=1, gap_extend=2),  # out-of-regime
        WfaPenalties(mismatch=1, gap_open=5, gap_extend=1),
    ):
        res = native.wfa_textbook_align_batch_native(pairs, pen)
        assert res is not None
        for (s1, s2), r in zip(pairs, res):
            assert r is not None
            p, a1, a2 = r
            assert p == oracle_wfa.wfa_textbook_score(s1, s2, pen)
            assert a1.replace("-", "").encode() == s1
            assert a2.replace("-", "").encode() == s2
            assert _penalty_of(a1, a2, pen) == p
            if not s1 or not s2:
                continue
            batch = pack_batch([(s1, s2)], batch_size=8)
            tr = wfa_textbook_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                penalties=pen, band=80, s_max=2048,
            )
            assert bool(np.asarray(tr.converged)[0])
            pt, t1, t2 = wfa_traceback_host(tr, 0, s1, s2, pen)
            assert (pt, t1, t2) == (p, a1, a2)


def test_native_engine_model_routing():
    """wfa_engine='native' forces the host engine; 'auto' out-of-regime
    prefers it over the wavefront engine."""
    from sequencealigning_tpu.config import AlignConfig, Algo, WfaPenalties
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops import oracle_wfa

    pen = WfaPenalties(mismatch=9, gap_open=1, gap_extend=2)
    for engine in ("native", "auto"):
        cfg = AlignConfig(
            algo=Algo.WFA, compat=False, wfa_penalties=pen,
            wfa_engine=engine,
        )
        al = get_aligner(cfg)
        for s1, s2 in _random_pairs(5, n=4, lo=4, hi=30, maxdiff=5):
            r = al.align_pair(
                Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d")
            )
            assert r.ok, r.error
            assert r.score == oracle_wfa.wfa_textbook_score(s1, s2, pen)
            assert _penalty_of(r.aligned_query, r.aligned_db, pen) == r.score


def test_forced_banded_engine_exact_out_of_regime_scheme():
    """wfa_engine='banded' outside the coincidence regime used to refuse
    (round 4: the M-only Gotoh model would report the wrong penalty);
    it now switches to the kernel's any-state-open variant
    (ops.nw_banded_diag model='std') and must be exact
    (tests/test_std_affine.py covers the engine in depth)."""
    from sequencealigning_tpu.config import AlignConfig, Algo, WfaPenalties
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops import oracle_wfa

    pen = WfaPenalties(mismatch=9, gap_open=1, gap_extend=2)
    al = get_aligner(AlignConfig(
        algo=Algo.WFA, compat=False, wfa_penalties=pen, wfa_engine="banded",
    ))
    pairs = [(b"ACGT", b"AGGT"), (b"ACGTACGTAC", b"ACGACGTTAC")]
    out = al._align_batch_impl(pairs)
    for (s1, s2), r in zip(pairs, out):
        assert isinstance(r, dict), r
        assert r["score"] == oracle_wfa.wfa_textbook_score(s1, s2, pen)
        assert _penalty_of(r["aligned_query"], r["aligned_db"], pen) == r["score"]


def test_native_engine_adversarial_shapes():
    """Boundary-clamp stress for the native engine's staged (vectorized)
    wavefront loops: extreme length skews and all-mismatch pairs drive the
    spans into the k_min/k_max clamps and the all-WFA_NEG flank fills of
    twf_gather; every result must match the Python oracle exactly."""
    import random

    from sequencealigning_tpu import native
    from sequencealigning_tpu.ops import oracle_wfa

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")

    rng = random.Random(99)
    pairs = [
        (b"A", b"T" * 40),                      # 1 x 40, nothing matches
        (b"ACGT" * 12, b"G"),                    # 48 x 1
        (b"A" * 30, b"A" * 3),                   # homopolymer, pure gaps
        (b"AC" * 20, b"CA" * 20),                # frame-shifted repeat
        (b"A" * 25, b"T" * 25),                  # every diagonal mismatches
    ]
    for _ in range(12):  # skew up to ~1:15
        n1 = rng.randint(1, 45)
        n2 = rng.randint(1, 45)
        pairs.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    for pen in (
        WfaPenalties(),
        WfaPenalties(mismatch=9, gap_open=1, gap_extend=2),
        WfaPenalties(mismatch=1, gap_open=7, gap_extend=3),
    ):
        res = native.wfa_textbook_align_batch_native(pairs, pen)
        assert res is not None
        for (s1, s2), r in zip(pairs, res):
            assert r is not None, (s1, s2)
            p, a1, a2 = r
            assert p == oracle_wfa.wfa_textbook_score(s1, s2, pen), (s1, s2)
            assert a1.replace("-", "").encode() == s1
            assert a2.replace("-", "").encode() == s2
            assert _penalty_of(a1, a2, pen) == p
