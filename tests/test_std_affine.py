"""Any-state-affine ("std") banded engine: the WFA certificate route for
penalty schemes OUTSIDE the coincidence regime (VERDICT r4 item 5).

WFA's merged M-wavefront is the STANDARD gap-affine model (gaps open
from the best of M/I/D, wfa.rs:353-398) while the reference's Gotoh
opens from M only (needleman_wunsch_affine.rs:87-94); the two diverge
iff mismatch > 2*gap_extend in penalty terms (PARITY.md).  These tests
pin ops.nw_banded_diag's model="std" variant to

* a scalar std-affine oracle (oracle_gotoh.gotoh_fill model="std"),
* the independent exact WFA oracle (oracle_wfa.wfa_textbook_score --
  different formalism entirely: score-indexed wavefronts), and
* alignment validity (walked CIGARs rescore to the exact penalty under
  standard-affine rules),

and exercise the model route end-to-end (WfaAligner auto dispatch picks
the std banded engine out-of-regime, including the full-width fallback
past the band cap).
"""

import numpy as np
import pytest

from sequencealigning_tpu.config import (
    AlignConfig,
    Algo,
    ScoringScheme,
    WfaPenalties,
)
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.io.fasta import Record
from sequencealigning_tpu.models.wfa import WfaAligner
from sequencealigning_tpu.ops import oracle_gotoh, oracle_wfa
from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu.ops.traceback import (
    banded_diag_fast4_traceback_pair,
)

# Out-of-regime: mismatch (10) > 2 * gap_extend (2) -> the models diverge.
PEN = WfaPenalties(mismatch=10, gap_open=3, gap_extend=1)
EQ = ScoringScheme(match_=0, mismatch=-10, gap_open=-3, gap_extend=-1)

ALPHA = np.frombuffer(b"ACGT", np.uint8)


def _mk_pairs(n_pairs, rng, max_len=60):
    pairs = []
    for _ in range(n_pairs):
        n = int(rng.integers(5, max_len))
        s2 = rng.choice(ALPHA, n).tobytes()
        s1 = bytearray(s2)
        for _ in range(int(rng.integers(0, 6))):
            i = int(rng.integers(0, max(1, len(s1))))
            op = int(rng.integers(0, 3))
            if op == 0 and len(s1):
                s1[i] = int(rng.choice(ALPHA))
            elif op == 1 and len(s1) > 3:
                del s1[i]
            else:
                s1.insert(i, int(rng.choice(ALPHA)))
        pairs.append((bytes(s1), s2))
    return pairs


def _rescore_std(a1, a2, scheme=EQ):
    """Score an aligned pair under standard gap-affine rules (gap runs
    are charged open+extend on every direction change)."""
    sc = 0
    prev = None
    for c1, c2 in zip(a1, a2):
        op = "D" if c1 == "-" else ("I" if c2 == "-" else "M")
        if op == "M":
            sc += scheme.match_ if c1 == c2 else scheme.mismatch
        else:
            sc += scheme.gap_extend + (scheme.gap_open if op != prev else 0)
        prev = op
    assert a1.replace("-", "") != "" or a2.replace("-", "") != "" or sc == 0
    return sc


def test_std_oracle_matches_wfa_oracle():
    """The std-affine Gotoh oracle and the score-indexed WFA oracle are
    independent formalisms of the SAME model: negated scores must agree
    on every fuzzed pair (and differ from the ref model on some)."""
    rng = np.random.default_rng(11)
    pairs = _mk_pairs(40, rng)
    n_div = 0
    for s1, s2 in pairs:
        std = oracle_gotoh.gotoh_score(s1, s2, EQ, compat=False, model="std")
        ref = oracle_gotoh.gotoh_score(s1, s2, EQ, compat=False, model="ref")
        wfa = oracle_wfa.wfa_textbook_score(s1, s2, PEN)
        assert std == -wfa, (s1, s2, std, wfa)
        if std != ref:
            n_div += 1
    assert n_div > 0  # the scheme genuinely separates the models


def test_banded_diag_std_scores_and_walks():
    """Kernel (lax) std fill == std oracle; host + device walks rescore
    to the exact score and consume the sequences exactly."""
    from sequencealigning_tpu.ops.traceback_device import (
        banded_diag_device_tbs,
    )

    rng = np.random.default_rng(3)
    pairs = _mk_pairs(24, rng)
    batch = pack_batch(pairs, batch_size=24)
    res = nw_banded_diag_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=64, scheme=EQ, compat=False, with_dirs="fast4",
        model="std", backend="lax",
    )
    f = np.asarray(res.finals)
    dirs = np.asarray(res.dirs)
    n_div = 0
    for b, (s1, s2) in enumerate(pairs):
        want = oracle_gotoh.gotoh_score(
            s1, s2, EQ, compat=False, model="std"
        )
        got = int(f[b].max())
        assert got == want, (b, got, want)
        if want != oracle_gotoh.gotoh_score(s1, s2, EQ, compat=False):
            n_div += 1
        score, alns = banded_diag_fast4_traceback_pair(
            dirs[:, b, :], f[b], s1, s2, res.k_lo_even, compat=False,
            std=True,
        )
        a1, a2 = alns[0]
        assert _rescore_std(a1, a2) == want, (b, a1, a2)
        assert a1.replace("-", "").encode() == s1
        assert a2.replace("-", "").encode() == s2
    assert n_div > 0
    tbs = banded_diag_device_tbs(
        res.dirs, f, [p[0] for p in pairs], [p[1] for p in pairs],
        res.k_lo_even, compat=False, std=True,
    )
    for b, (s1, s2) in enumerate(pairs):
        score, alns = tbs[b]
        assert score == int(f[b].max())
        assert _rescore_std(alns[0][0], alns[0][1]) == score, b


def test_std_model_rejects_compat_and_full_dirs():
    batch = pack_batch([(b"ACGT", b"ACGT")], batch_size=8)
    for kw in (dict(compat=True), dict(compat=False, with_dirs="full")):
        with pytest.raises(ValueError, match="std"):
            nw_banded_diag_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                band=16, scheme=EQ, model="std", backend="lax", **kw
            )


def _cfg(**kw):
    return AlignConfig(
        algo=Algo.WFA, compat=False, wfa_penalties=PEN, band=8, **kw
    )


def test_wfa_auto_route_out_of_regime_uses_std_banded(monkeypatch):
    """End-to-end: WfaAligner auto dispatch on an out-of-regime scheme
    returns the exact WFA penalty AND a valid alignment for every pair
    (round 4 could only answer with the 850 pairs/s wavefront engine
    here).  Native host leg disabled so the banded-std route is what
    gets exercised."""
    monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
    rng = np.random.default_rng(7)
    pairs = _mk_pairs(12, rng)
    al = WfaAligner(_cfg())
    out = al._align_batch_impl(pairs)
    for (s1, s2), r in zip(pairs, out):
        assert isinstance(r, dict), r
        want = oracle_wfa.wfa_textbook_score(s1, s2, PEN)
        assert r["score"] == want, (s1, s2, r, want)
        a1, a2 = r["aligned_query"], r["aligned_db"]
        assert _rescore_std(a1, a2) == -want
        assert a1.replace("-", "").encode() == s1
        assert a2.replace("-", "").encode() == s2


def test_wfa_std_full_width_fallback_past_band_cap(monkeypatch):
    """Pairs whose optimum disagrees across bands escalate; past the cap
    the std route runs ONE full-width round (complete DP -- cannot
    escape) instead of the wrong-model Gotoh fallback."""
    monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
    # A big displaced block forces real band escapes at tiny caps.
    s1 = b"ACGT" * 12
    s2 = b"TTTTTTTT" * 3 + b"ACGT" * 12
    al = WfaAligner(_cfg())
    al.wfa_banded_max_band = 8  # force the full-width fallback
    out = al._align_batch_impl([(s1, s2)])
    (r,) = out
    assert isinstance(r, dict), r
    want = oracle_wfa.wfa_textbook_score(s1, s2, PEN)
    assert r["score"] == want
    assert _rescore_std(r["aligned_query"], r["aligned_db"]) == -want


def test_banded_diag_std_pallas_interpret_matches_lax():
    """The std-model diag fill (the lax twin the CUDA kernel is pinned
    to): band-covered finals equal the std oracle and every walked
    alignment rescores to its score."""
    rng = np.random.default_rng(19)
    pairs = _mk_pairs(16, rng, max_len=48)
    batch = pack_batch(pairs, batch_size=16)
    a = nw_banded_diag_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=64, scheme=EQ, compat=False, with_dirs="fast4", model="std",
        backend="lax",
    )
    fa = np.asarray(a.finals)
    da = np.asarray(a.dirs)
    for i, (s1, s2) in enumerate(pairs):
        want = oracle_gotoh.gotoh_score(s1, s2, EQ, compat=False, model="std")
        assert int(fa[i].max()) == want, i
        score, alns = banded_diag_fast4_traceback_pair(
            da[:, i, :], fa[i], s1, s2, a.k_lo_even, compat=False, std=True
        )
        assert score == want and _rescore_std(*alns[0]) == want, i
