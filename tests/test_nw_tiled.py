"""Tiled long-pair affine fill: tile-boundary carry == full Gotoh oracle,
and the GotohAligner long-pair path (exact score + verified banded
alignment)."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_batch


def _pairs(seed, n=8, lo=1, hi=300):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        n1 = rng.randint(lo, hi)
        n2 = rng.randint(lo, hi)
        out.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    return out


@pytest.mark.parametrize("compat", [True, False])
def test_tiled_lax_matches_oracle_across_tiles(compat):
    """tile_lanes=128 forces multi-tile boundary carries at these sizes."""
    pairs = _pairs(31, hi=300)
    batch = pack_batch(pairs, batch_size=8)
    finals = nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat, tile_lanes=128,
    )
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in finals[b]) == exp, (b, s1, s2)


def test_tiled_matches_plain_fill_and_edges():
    """Tiled finals == the plain full fill on a mixed batch including a
    single-char and an empty-db pair (closed-form corner)."""
    from sequencealigning_tpu.ops.nw_affine import nw_affine_batch

    pairs = _pairs(37, n=6, hi=150) + [(b"ACGT", b"A"), (b"ACG", b"")]
    batch = pack_batch(pairs, batch_size=8)
    tiled = nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=True, tile_lanes=128,
    )
    full = np.asarray(
        nw_affine_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            compat=True, with_dirs=False,
        ).finals
    )
    assert np.array_equal(tiled[: len(pairs)], full[: len(pairs)])


@pytest.mark.parametrize("compat", [True, False])
def test_tiled_pallas_matches_oracle(compat):
    """256-lane tiles over pairs up to 500: the tiled lax fill (the
    long-pair engine on every platform) against the oracle."""
    pairs = _pairs(41, hi=500)
    batch = pack_batch(pairs, batch_size=8)
    finals = nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat, tile_lanes=256,
    )
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in finals[b]) == exp, (b, s1, s2)


def test_long_pair_model_path(monkeypatch):
    """GotohAligner routes over-budget batches through tiled score +
    band-doubled verified alignment.  Exercised at CPU scale by lowering
    the lane threshold."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner

    al = get_aligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    monkeypatch.setattr(type(al), "long_pair_lanes", 64)
    rng = random.Random(43)
    n = 200
    s1 = bytes(rng.choice(b"ACGT") for _ in range(n))
    s2l = list(s1)
    for i in range(0, n, 17):
        s2l[i] = rng.choice(b"ACGT")
    del s2l[50:55]  # an indel to exercise off-diagonal alignment
    s2 = bytes(s2l)

    res = al.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
    assert res.ok, res.error
    assert res.score == oracle_gotoh.gotoh_score(s1, s2)
    assert res.aligned_query is not None
    # The alignment must reproduce the two sequences when gaps are removed.
    assert res.aligned_query.replace("-", "") == s1.decode()
    assert res.aligned_db.replace("-", "") == s2.decode()


def test_long_pair_band_escape_falls_to_myers_miller(monkeypatch):
    """If the optimum escapes even the max band, the Myers-Miller fallback
    still produces the exact score AND an exact alignment."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner

    al = get_aligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    monkeypatch.setattr(type(al), "long_pair_lanes", 64)
    monkeypatch.setattr(type(al), "long_pair_max_band", 2)
    # Optimal path needs a 60-long gap: escapes band 2 (and the doubling
    # cap); the tiled score is exact and mm_align recovers the CIGAR.
    s1 = b"G" * 60 + b"A" * 40
    s2 = b"A" * 40
    res = al.align_pair(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))
    assert res.ok
    assert res.score == oracle_gotoh.gotoh_score(s1, s2)
    assert res.aligned_query is not None
    assert res.aligned_query.replace("-", "").encode() == s1
    assert res.aligned_db.replace("-", "").encode() == s2


@pytest.mark.parametrize("compat", [True, False])
def test_folded_single_matches_oracle(compat):
    """The sublane-folded single-pair fill (8 consecutive x-tiles on the 8
    sublanes, cross-seam x-1 exchange) must equal the full Gotoh oracle,
    including multi-virtual-tile lengths."""
    from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_single

    rng = random.Random(13)
    for n1, n2 in [(50, 300), (120, 1100), (7, 40), (260, 257), (1, 1)]:
        s1 = bytes(rng.choice(b"ACGT") for _ in range(n1))
        s2 = bytes(rng.choice(b"ACGT") for _ in range(n2))
        f = nw_affine_tiled_single(
            s1, s2, compat=compat, tile_lanes=128
        )
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in f) == exp, (n1, n2)


def test_folded_single_pallas_matches_lax():
    """One 300 x 2100 pair folded over all 8 rows: oracle corner."""
    from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_single

    rng = random.Random(17)
    s1 = bytes(rng.choice(b"ACGT") for _ in range(300))
    s2 = bytes(rng.choice(b"ACGT") for _ in range(2100))
    fl = nw_affine_tiled_single(s1, s2, tile_lanes=128)
    m, i_, d = oracle_gotoh.gotoh_fill(s1, s2)
    assert tuple(int(v) for v in fl) == (
        int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1])
    )


@pytest.mark.parametrize("compat", [True, False])
def test_fold_batch_matches_oracle(compat):
    """Small-batch folded fill: B pairs share the 8 sublanes (fold =
    8 // ceil_pow2(B)).  Every pair's corner finals must equal the full
    Gotoh oracle for every B in 1..4, at mixed lengths spanning several
    virtual-tile seams (tile_lanes=128 -> fold*128-wide virtual tiles)."""
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_fold_batch,
    )

    rng = random.Random(23)
    cases = {
        1: [(50, 300)],
        2: [(120, 900), (40, 37)],
        3: [(9, 260), (130, 130), (1, 520)],
        4: [(300, 120), (64, 64), (2, 3), (111, 430)],
    }
    for B, lens in cases.items():
        pairs = [
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
            for n1, n2 in lens
        ]
        batch = pack_batch(pairs)
        f = nw_affine_tiled_fold_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            compat=compat, tile_lanes=128,
        )
        assert f.shape == (B, 3)
        for b, (s1, s2) in enumerate(pairs):
            m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
            exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
            assert tuple(int(v) for v in f[b]) == exp, (B, b, lens[b])


def test_fold_batch_degenerate_lengths():
    """Empty query / empty db rows inside a fold batch take the
    closed-form boundary corners (and must not disturb other rows)."""
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_fold_batch,
    )

    pairs = [(b"ACGT" * 10, b""), (b"", b"ACGTT" * 8), (b"ACCA", b"ACCA")]
    batch = pack_batch(pairs)
    f = nw_affine_tiled_fold_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        tile_lanes=128,
    )
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in f[b]) == exp, b


def test_fold_batch_pallas_matches_lax():
    """Three long pairs: the folded fill equals the batched tiled fill."""
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_fold_batch,
    )

    pairs = _pairs(41, n=3, lo=150, hi=2100)
    batch = pack_batch(pairs)
    args = (batch.query, batch.db, batch.query_len, batch.db_len)
    fl = nw_affine_tiled_fold_batch(*args, tile_lanes=128)
    fb = nw_affine_tiled_batch(*args, tile_lanes=128)
    assert np.array_equal(fl, fb[: len(pairs)])


@pytest.mark.parametrize(
    "lens,want_fold",
    [
        ([(90, 95), (100, 92), (88, 99)], True),  # similar sizes: 1 dispatch
        ([(100, 100), (4, 3)], False),  # mixed: padding would dominate
    ],
)
def test_long_batch_fold_routing(monkeypatch, lens, want_fold):
    """The long-pair model path routes B <= 4 batches through the folded
    small-batch fill only when the pairs are similar-sized
    (sum(cells) >= 0.7 * G * max(cells)); wildly mixed sizes stay on
    serial folded singles.  Either way results are exact."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops import nw_affine_tiled

    calls = []
    real = nw_affine_tiled.nw_affine_tiled_fold_batch

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(nw_affine_tiled, "nw_affine_tiled_fold_batch", spy)
    rng = random.Random(51)
    pairs = [
        (
            bytes(rng.choice(b"ACGT") for _ in range(n1)),
            bytes(rng.choice(b"ACGT") for _ in range(n2)),
        )
        for n1, n2 in lens
    ]
    al = get_aligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True))
    monkeypatch.setattr(type(al), "long_pair_lanes", 64)
    recs = [
        (Record(seq=a, name=b">q"), Record(seq=b, name=b">d"))
        for a, b in pairs
    ]
    res = al.align_batch(recs)
    # Serial folded singles route through the same entry at B=1 each
    # (nw_affine_tiled_single is its B=1 case).
    assert calls == ([len(pairs)] if want_fold else [1] * len(pairs))
    for r, (s1, s2) in zip(res, pairs):
        assert r.ok, r.error
        assert r.score == oracle_gotoh.gotoh_score(s1, s2)
        assert r.aligned_query.replace("-", "").encode() == s1
        assert r.aligned_db.replace("-", "").encode() == s2
