"""Streamed-pair Gotoh fill tests: the lax twin vs the scalar oracle,
stream-layout traceback vs the plain fill's.  The CUDA kernel is pinned
bit for bit to this lax twin on the card (chip_smoke.py and the
gpu-marked tests in test_cuda_fills.py)."""

import os
import random

import numpy as np
import pytest

from sequencealigning_tpu.errors import AlignmentError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.ops.nw_affine import nw_affine_batch
from sequencealigning_tpu.ops.nw_affine_stream import (
    nw_affine_stream_batch,
    plan_stream,
)
from sequencealigning_tpu.ops.traceback import (
    traceback_batch,
    traceback_stream_batch,
)


def _random_pairs(seed, n_pairs=48, lo=2, hi=14, alphabet=b"ACGT"):
    rng = random.Random(seed)
    return [
        (
            bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
            bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
        )
        for _ in range(n_pairs)
    ]


def _assert_lax_matches_oracle(pairs, res, compat=True, dirs="full"):
    """Corner finals equal the oracle's; with dirs, the walked first
    alignment is the oracle's first co-optimal one (full layout) or an
    optimal alignment of both sequences (fast4)."""
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in res.finals[b]) == exp, (b, s1, s2)
    if not dirs:
        return
    tbs = traceback_stream_batch(
        np.asarray(res.dirs), res.finals, [p[0] for p in pairs],
        [p[1] for p in pairs], res.plan, compat=compat, dirs_mode=dirs,
    )
    for b, r in enumerate(tbs):
        s1, s2 = pairs[b]
        try:
            score, exp = oracle_gotoh.gotoh_traceback_all(
                s1, s2, compat=compat
            )
        except AlignmentError as e:
            # The reference's own traceback fails here (compat boundary
            # quirk); the full layout reproduces that error.
            if dirs == "full":
                assert isinstance(r, AlignmentError), (b, r, e)
            continue
        if isinstance(r, Exception):
            assert not exp, (b, r)
            continue
        assert r[0] == score, (b, r[0], score)
        a1, a2 = r[1][0]
        assert a1.replace("-", "").encode() == s1
        assert a2.replace("-", "").encode() == s2
        if dirs == "full":
            assert (a1, a2) == tuple(exp[0]), (b, s1, s2)


def _stream(pairs, compat=True, backend="lax", wildcard=False,
            with_dirs=True, np_slots=3):  # with_dirs: True/'full'/'fast4'/False
    batch = pack_batch(pairs, batch_size=len(pairs))
    res = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat, wildcard=wildcard, with_dirs=with_dirs,
        backend=backend, np_slots=np_slots,
    )
    return res, batch


@pytest.mark.parametrize("compat", [True, False])
def test_stream_lax_finals_match_oracle(compat):
    pairs = _random_pairs(3)
    res, _ = _stream(pairs, compat=compat, backend="lax")
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        got = tuple(int(v) for v in res.finals[b])
        assert exp == got, (b, s1, s2, exp, got)


def test_stream_wildcard_matches_plain_kernel():
    pairs = _random_pairs(5, alphabet=b"ACGTN")
    batch = pack_batch(pairs, batch_size=48)
    res_s, _ = _stream(pairs, backend="lax", wildcard=True)
    res_p = nw_affine_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        wildcard=True,
    )
    np.testing.assert_array_equal(res_s.finals, np.asarray(res_p.finals)[:48])


@pytest.mark.parametrize("compat", [True, False])
def test_stream_pallas_interpret_matches_lax(compat):
    """Full-layout streamed fill (the shapes the removed interpret-mode
    kernel test used) against the oracle: finals and first alignment."""
    pairs = _random_pairs(11)
    r_lax, _ = _stream(pairs, compat=compat, backend="lax")
    _assert_lax_matches_oracle(pairs, r_lax, compat=compat, dirs="full")


@pytest.mark.parametrize("compat", [True, False])
def test_stream_traceback_matches_plain(compat):
    pairs = _random_pairs(17, n_pairs=24, hi=12)
    res_s, batch = _stream(pairs, compat=compat, backend="lax", np_slots=3)
    res_p = nw_affine_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat,
    )
    seqs1 = [p[0] for p in pairs]
    seqs2 = [p[1] for p in pairs]
    got = traceback_stream_batch(
        res_s.dirs, res_s.finals, seqs1, seqs2, res_s.plan, compat=compat,
    )
    exp = traceback_batch(
        res_p.dirs, np.asarray(res_p.finals)[: len(pairs)], seqs1, seqs2,
        compat=compat,
    )
    for b, (g, e) in enumerate(zip(got, exp)):
        if isinstance(e, Exception):
            assert isinstance(g, type(e)) and str(g) == str(e), (b, g, e)
        else:
            assert g == e, (b, pairs[b], g, e)


def test_stream_native_first_path_matches_python():
    pairs = _random_pairs(23, n_pairs=24, hi=12)
    res_s, _ = _stream(pairs, backend="lax", np_slots=3)
    seqs1 = [p[0] for p in pairs]
    seqs2 = [p[1] for p in pairs]
    native = traceback_stream_batch(
        res_s.dirs, res_s.finals, seqs1, seqs2, res_s.plan, first_only=True,
    )
    os.environ["SEQALIGN_NO_NATIVE"] = "1"
    try:
        py = traceback_stream_batch(
            res_s.dirs, res_s.finals, seqs1, seqs2, res_s.plan,
            first_only=True,
        )
    finally:
        del os.environ["SEQALIGN_NO_NATIVE"]
    norm = lambda xs: [
        (type(x).__name__, str(x)) if isinstance(x, Exception) else x
        for x in xs
    ]
    assert norm(native) == norm(py)


def test_plan_coords_roundtrip():
    plan = plan_stream(48, 14, 14, np_slots=3)
    assert plan.np_slots == 3 and plan.n_rows == 16
    seen = set()
    for b in range(48):
        r, k, off = plan.pair_coords(b)
        assert off == k * plan.s
        seen.add((r, k))
    assert len(seen) == 48


@pytest.mark.parametrize("compat", [True, False])
def test_fast4_dirs_traceback_scores_exact(compat):
    """fast4 (4-bit first-path) dirs: the walked alignment must be a valid
    optimal alignment (score recomputed from the gapped pair == finals)."""
    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.ops.traceback import traceback_stream_batch

    pairs = _random_pairs(41, n_pairs=24, hi=16)
    batch = pack_batch(pairs, batch_size=24)
    res = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat, with_dirs="fast4", backend="lax", np_slots=3,
    )
    sch = ScoringScheme()

    def rescore(a1, a2):
        s = 0
        gap = None
        for c1, c2 in zip(a1, a2):
            if c1 == "-" or c2 == "-":
                g = 1 if c1 == "-" else 2
                s += sch.gap_extend + (sch.gap_open if gap != g else 0)
                gap = g
            else:
                s += sch.match_ if c1 == c2 else sch.mismatch
                gap = None
        return s

    tbs = traceback_stream_batch(
        np.asarray(res.dirs), res.finals,
        [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
        compat=compat, dirs_mode="fast4",
    )
    n_checked = 0
    for b, r in enumerate(tbs):
        if isinstance(r, Exception):
            continue
        score, alns = r
        a1, a2 = alns[0]
        assert a1.replace("-", "").encode() == pairs[b][0]
        assert a2.replace("-", "").encode() == pairs[b][1]
        exp = int(res.finals[b].max())
        got = rescore(a1, a2)
        if compat:
            # Compat boundary chains charge one extra extension per gap run
            # on the matrix edge (open + (k+1)*ext), so the textbook
            # rescoring of the walked alignment reads up to two extensions
            # HIGHER than the compat score.
            assert got in (exp, exp - sch.gap_extend, exp - 2 * sch.gap_extend), (
                b, pairs[b], exp, got, a1, a2,
            )
        else:
            assert got == exp, (b, pairs[b], exp, got, a1, a2)
        n_checked += 1
    assert n_checked >= 20


def test_fast4_pallas_matches_lax():
    """fast4 streamed fill against the oracle: finals and an optimal
    walked alignment per pair."""
    pairs = _random_pairs(43, n_pairs=24, hi=14)
    r_lax, _ = _stream(pairs, backend="lax", np_slots=3, with_dirs="fast4")
    _assert_lax_matches_oracle(pairs, r_lax, dirs="fast4")


@pytest.mark.parametrize("compat", [True, False])
def test_stream_asymmetric_padded_shapes(compat):
    """Padded query/db lengths differ (L1p != L2p): exercises S > P (long
    queries) and S > L1 (long dbs) plus the drain-slot math."""
    rng = random.Random(59)

    def mk(lo1, hi1, lo2, hi2, n):
        return [
            (
                bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo1, hi1))),
                bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo2, hi2))),
            )
            for _ in range(n)
        ]

    for pairs in (
        mk(130, 250, 2, 50, 16),    # query pads to 256, db to 128
        mk(2, 50, 130, 250, 16),    # db pads to 256, query to 128
    ):
        batch = pack_batch(pairs, batch_size=16)
        for backend in ("lax",):
            res = nw_affine_stream_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                compat=compat, with_dirs=False, backend=backend, np_slots=2,
            )
            for b, (s1, s2) in enumerate(pairs):
                exp = oracle_gotoh.gotoh_score(s1, s2, compat=compat)
                assert int(res.finals[b].max()) == exp, (
                    backend, b, len(s1), len(s2),
                )


@pytest.mark.parametrize("chunk", [64, 32])
@pytest.mark.parametrize("wd", ["full", "fast4"])
def test_stream_pallas_small_chunk_matches_lax(chunk, wd):
    """chunk=64/32 shorten the launch period s: finals and the walked
    alignments match the oracle and the default-chunk layout."""
    from sequencealigning_tpu.io.encode import pack_batch as _pb

    pairs = _random_pairs(23, n_pairs=16, hi=12)
    batch = _pb(pairs, batch_size=len(pairs))
    args = (batch.query, batch.db, batch.query_len, batch.db_len)
    r_lax = nw_affine_stream_batch(
        *args, with_dirs=wd, backend="lax", np_slots=2, chunk=chunk,
    )
    _assert_lax_matches_oracle(pairs, r_lax, dirs=wd)
    # Cross-chunk: finals are layout-independent (dirs words are NOT --
    # the launch period s = round_up(max(l1,l2)+1, chunk) shifts every
    # slot's d_offset), and the walked alignments agree.
    r_ref = nw_affine_stream_batch(
        *args, with_dirs=wd, backend="lax", np_slots=2, chunk=128,
    )
    np.testing.assert_array_equal(r_ref.finals, r_lax.finals)
    if wd == "full":
        seqs1 = [p[0] for p in pairs]
        seqs2 = [p[1] for p in pairs]
        got = traceback_stream_batch(
            r_lax.dirs, r_lax.finals, seqs1, seqs2, r_lax.plan,
        )
        exp = traceback_stream_batch(
            r_ref.dirs, r_ref.finals, seqs1, seqs2, r_ref.plan,
        )
        for b, (g, e) in enumerate(zip(got, exp)):
            if isinstance(e, Exception):
                assert isinstance(g, type(e)) and str(g) == str(e), (b, g, e)
            else:
                assert g == e, (b, pairs[b], g, e)


@pytest.mark.tier2  # multi-minute sweep; quick loop: -m 'not tier2'
def test_stream_int16_state_matches_int32():
    """int16 score state (half the state bytes; the lax engine's) must be
    bit-identical to int32 on the WALKED contracts:
    finals and traceback alignments.  Raw dirs words may differ only at
    never-walked positions (sentinel-vs-sentinel extend flags: the int32
    sentinel decays unboundedly, the int16 one is floor-clamped)."""
    import jax.numpy as jnp

    from sequencealigning_tpu.ops.traceback import traceback_stream_batch

    pairs = _random_pairs(31, n_pairs=24, hi=14)
    batch = pack_batch(pairs, batch_size=len(pairs))
    seqs1 = [p[0] for p in pairs]
    seqs2 = [p[1] for p in pairs]
    for compat in (True, False):
        for backend in ("lax",):
            for dm in ("full", "fast4", False):
                kw = dict(
                    compat=compat, with_dirs=dm, backend=backend, np_slots=3
                )
                r32 = nw_affine_stream_batch(
                    batch.query, batch.db, batch.query_len, batch.db_len, **kw
                )
                r16 = nw_affine_stream_batch(
                    batch.query, batch.db, batch.query_len, batch.db_len,
                    state_dtype=jnp.int16, **kw
                )
                np.testing.assert_array_equal(r32.finals, r16.finals)
                if not dm:
                    continue
                w32 = traceback_stream_batch(
                    np.asarray(r32.dirs), r32.finals, seqs1, seqs2, r32.plan,
                    compat=compat, dirs_mode=dm,
                )
                w16 = traceback_stream_batch(
                    np.asarray(r16.dirs), r16.finals, seqs1, seqs2, r16.plan,
                    compat=compat, dirs_mode=dm,
                )
                for b, (g, e) in enumerate(zip(w16, w32)):
                    if isinstance(e, Exception):
                        assert isinstance(g, type(e)) and str(g) == str(e)
                    else:
                        assert g == e, (compat, backend, dm, b, pairs[b])


def test_stream_int16_deep_negative_range():
    """Pure-mismatch pairs drive real DP cells deep below the int16
    sentinel's naive placement; the certified sentinel + clamp must keep
    finals exact (lax, score-only for speed)."""
    import jax.numpy as jnp

    n, L = 8, 384
    pairs = [(b"A" * L, b"T" * L)] * n
    batch = pack_batch(pairs, batch_size=n)
    r32 = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        with_dirs=False, backend="lax", np_slots=1,
    )
    r16 = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        with_dirs=False, backend="lax", np_slots=1, state_dtype=jnp.int16,
    )
    np.testing.assert_array_equal(r32.finals, r16.finals)
    assert int(r32.finals[0][0]) == -4 * L  # all-mismatch diagonal optimum


def test_stream_int16_gate_rejects_overflow():
    """A scheme x shape outside the closed-form int16 certification must
    be rejected, not silently wrapped."""
    import jax.numpy as jnp
    import pytest

    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.ops.nw_affine_stream import (
        plan_stream,
        stream_i16_neg,
    )

    big = ScoringScheme(match_=5, mismatch=-400, gap_open=-800, gap_extend=-600)
    plan = plan_stream(16, 60, 60)
    assert stream_i16_neg(big, plan) is None
    pairs = _random_pairs(7, n_pairs=16, hi=14)
    batch = pack_batch(pairs, batch_size=16)
    with pytest.raises(ValueError, match="int16"):
        nw_affine_stream_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            scheme=big, with_dirs=False, backend="lax",
            state_dtype=jnp.int16,
        )


def test_stream_state_auto_resolution_and_model_knob():
    """"auto" resolves to int16 on the CPU exactly when the range
    certifies; the model-level knob produces identical results either
    way."""
    import jax.numpy as jnp

    from sequencealigning_tpu.config import AlignConfig, Algo, ScoringScheme
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops.nw_affine_stream import (
        plan_stream,
        resolve_stream_state,
    )

    plan = plan_stream(16, 60, 60)
    assert resolve_stream_state("i32", ScoringScheme(), plan) == jnp.int32
    assert resolve_stream_state("i16", ScoringScheme(), plan) == jnp.int16
    assert resolve_stream_state("auto", ScoringScheme(), plan) == jnp.int16
    big = ScoringScheme(match_=5, mismatch=-400, gap_open=-800,
                        gap_extend=-600)
    assert resolve_stream_state("auto", big, plan) == jnp.int32

    pairs = _random_pairs(41, n_pairs=10, hi=12)
    recs = [
        (Record(seq=a, name=b">q"), Record(seq=b, name=b">d"))
        for a, b in pairs
    ]
    outs = {}
    for ss in ("i32", "auto"):
        al = get_aligner(
            AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, stream_state=ss)
        )
        outs[ss] = [al.align_pair(q, d) for q, d in recs]
    for r32, r16 in zip(outs["i32"], outs["auto"]):
        assert r32.score == r16.score
        assert r32.aligned_query == r16.aligned_query
        assert r32.aligned_db == r16.aligned_db


def test_stream_int16_certification_boundary():
    """Schemes with large per-char costs reach the int16 boundary at tiny
    lengths: everything the gate certifies must be bit-exact vs int32,
    and the gate must reject the next notch up."""
    import random

    import jax.numpy as jnp

    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.ops.nw_affine_stream import (
        plan_stream,
        stream_i16_neg,
    )

    rng = random.Random(83)
    n, lo, hi = 12, 2, 24
    pairs = [
        (
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi))),
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi))),
        )
        for _ in range(n)
    ]
    # pure-mismatch and pure-gap extremes drive cells toward the bounds
    pairs += [(b"A" * hi, b"T" * hi), (b"A" * hi, b"C"), (b"G", b"T" * hi)]
    batch = pack_batch(pairs, batch_size=len(pairs))
    checked = rejected = 0
    # The boundary chain runs to p = S-1 (S >= 128), so gap_extend is the
    # chain-bound lever; mismatch drives the per-cell bound at tiny
    # lengths; match drives the stale-growth upper bound over S steps.
    for sch in (
        # certifies, sentinel near -28k (deep negative stress; the gate
        # sees the PADDED lengths, 128 here)
        ScoringScheme(match_=5, mismatch=-110, gap_open=-8, gap_extend=-6),
        # certifies, upper growth bound within ~2k of INT16_MAX
        # (S rounds to 256, so the growth term is match * 384)
        ScoringScheme(match_=80, mismatch=-4, gap_open=-8, gap_extend=-6),
        # rejected: chain o + (S+1)e past INT16_MIN
        ScoringScheme(match_=5, mismatch=-300, gap_open=-200, gap_extend=-250),
        # rejected: stale growth match*(len+S) past INT16_MAX
        ScoringScheme(match_=600, mismatch=-4, gap_open=-8, gap_extend=-6),
    ):
        plan = plan_stream(len(pairs), batch.query.shape[1],
                           batch.db.shape[1], np_slots=2)
        if stream_i16_neg(sch, plan) is None:
            rejected += 1
            continue
        checked += 1
        r32 = nw_affine_stream_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            scheme=sch, with_dirs=False, backend="lax", np_slots=2,
        )
        r16 = nw_affine_stream_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            scheme=sch, with_dirs=False, backend="lax", np_slots=2,
            state_dtype=jnp.int16,
        )
        np.testing.assert_array_equal(r32.finals, r16.finals)
    # the suite must exercise both sides of the gate
    assert checked >= 2 and rejected >= 1, (checked, rejected)


# ---------------------------------------------------------------------------
# Rows wider than the CUDA kernel holds (4-49 kb db): still the streamed
# fill, on its lax twin (sequencealigning_tpu.backend), not the long-pair
# path -- so co-optimal mode keeps its full alignment list.
# ---------------------------------------------------------------------------


def _wide_pairs(seed, n, length=5000):
    from sequencealigning_tpu import backend
    from sequencealigning_tpu.utils.synth import mutated_pairs

    pairs = mutated_pairs(np.random.default_rng(seed), n, length, 0.005)
    assert min(len(d) for _, d in pairs) + 2 > backend.CUDA_MAX_LANES["stream"]
    return pairs


def test_gotoh_co_optimal_past_the_cuda_lane_limit(monkeypatch):
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models.gotoh import GotohAligner
    from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_single
    from sequencealigning_tpu.utils.rescore import affine_rescore

    def no_long_path(*a, **k):
        raise AssertionError("a 5 kb pair took the long-pair path")

    monkeypatch.setattr(GotohAligner, "_long_batch", no_long_path)
    (s1, s2), = _wide_pairs(8, 1)
    al = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    r = al.align_batch([(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))])[0]
    exact = int(nw_affine_tiled_single(s1, s2).max())
    assert r.ok and r.score == exact
    alns = [tuple(a) for a in r.alignments]
    assert alns and len(set(alns)) == len(alns)
    for a1, a2 in alns:
        assert a1.replace("-", "").encode() == s1
        assert a2.replace("-", "").encode() == s2
        assert affine_rescore(a1, a2) == exact


def test_stream_align_past_the_cuda_lane_limit():
    from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_batch
    from sequencealigning_tpu.parallel.streaming import stream_align

    pairs = _wide_pairs(9, 16)
    got = {}
    n = stream_align(
        pairs, batch_size=8,
        on_result=lambda bi, fin: got.__setitem__(bi, np.asarray(fin)),
    )
    assert n == 16 and sorted(got) == [0, 1]
    batch = pack_batch(pairs, batch_size=16)
    exact = nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len
    )
    assert np.array_equal(
        np.concatenate([got[0], got[1]]).max(axis=1), exact[:16].max(axis=1)
    )
