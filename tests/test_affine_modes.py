"""Semi-global and local affine mode tests vs brute force."""

import random
from functools import lru_cache

import numpy as np
import pytest

from sequencealigning_tpu.config import AlignConfig, Algo, Mode
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.io.fasta import Record
from sequencealigning_tpu.models import get_aligner
from sequencealigning_tpu.ops.nw_affine_modes import (
    modes_end_cell,
    nw_affine_modes_batch,
)
from sequencealigning_tpu.ops.traceback import (
    local_affine_traceback_pair,
    semi_global_traceback_pair,
)


def brute_force_mode(seq1, seq2, mode, match=5, mismatch=-4, o=-8, e=-6):
    """Max score over alignments; semi: free end gaps both sides; local:
    best scoring segment pair.  Gaps open only from M."""
    n1, n2 = len(seq1), len(seq2)

    @lru_cache(maxsize=None)
    def go(y, x, state):
        # Best score of an alignment of seq1[y:] x seq2[x:] ENDING at the
        # far corner, with free trailing gaps in semi mode.
        if y == n1 and x == n2:
            return 0
        best = -(10 ** 9)
        if mode == "semi" and (y == n1 or x == n2):
            best = 0  # free trailing gap
        if mode == "local":
            best = 0  # stop anywhere
        if y < n1 and x < n2:
            sub = match if seq1[y] == seq2[x] else mismatch
            best = max(best, sub + go(y + 1, x + 1, 0))
        if y < n1 and state != 2:
            best = max(best, (e if state == 1 else o + e) + go(y + 1, x, 1))
        if x < n2 and state != 1:
            best = max(best, (e if state == 2 else o + e) + go(y, x + 1, 2))
        return best

    if mode == "semi":
        best = -(10 ** 9)
        for y in range(n1 + 1):
            best = max(best, go(y, 0, 0))  # free leading gap in seq1
        for x in range(n2 + 1):
            best = max(best, go(0, x, 0))
        return best
    # local: start anywhere
    best = 0
    for y in range(n1 + 1):
        for x in range(n2 + 1):
            best = max(best, go(y, x, 0))
    return best


def _pairs(seed, n=8, lo=2, hi=12):
    rng = random.Random(seed)
    return [
        (
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi))),
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi))),
        )
        for _ in range(n)
    ]


def _score_of_alignment(a1, a2, semi=False):
    score, st = 0, "M"
    cols = list(zip(a1, a2))
    # free end gaps: strip leading/trailing gap columns in semi mode
    if semi:
        while cols and ("-" in cols[0]):
            cols.pop(0)
        while cols and ("-" in cols[-1]):
            cols.pop()
    for c1, c2 in cols:
        if c1 == "-":
            score += -6 if st == "D" else -14
            st = "D"
        elif c2 == "-":
            score += -6 if st == "I" else -14
            st = "I"
        else:
            score += 5 if c1 == c2 else -4
            st = "M"
    return score


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_scores_match_brute_force(mode):
    pairs = _pairs(89 if mode == "semi" else 97)
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        local=(mode == "local"),
    )
    for b, (s1, s2) in enumerate(pairs):
        score, x, y = modes_end_cell(res, b)
        expect = brute_force_mode(s1, s2, mode)
        assert score == expect, (b, s1, s2, score, expect)


def test_semi_global_traceback_reconstructs_score():
    pairs = _pairs(101, n=6, hi=14)
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, local=False
    )
    dirs = np.asarray(res.dirs)
    for b, (s1, s2) in enumerate(pairs):
        score, x, y = modes_end_cell(res, b)
        a1, a2 = semi_global_traceback_pair(dirs[:, b, :], x, y, s1, s2)
        assert a1.replace("-", "") == s1.decode()
        assert a2.replace("-", "") == s2.decode()
        assert _score_of_alignment(a1, a2, semi=True) == score, (b, a1, a2)


def test_local_traceback_reconstructs_score():
    pairs = _pairs(103, n=6, hi=14)
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, local=True
    )
    dirs = np.asarray(res.dirs)
    for b, (s1, s2) in enumerate(pairs):
        score, x, y = modes_end_cell(res, b)
        a1, a2, sy, sx = local_affine_traceback_pair(
            dirs[:, b, :], x, y, s1, s2
        )
        assert _score_of_alignment(a1, a2) == score, (b, s1, s2, a1, a2)
        # segment really occurs at the reported coordinates
        assert s1.decode()[sy : sy + len(a1.replace("-", ""))] == a1.replace("-", "")
        assert s2.decode()[sx : sx + len(a2.replace("-", ""))] == a2.replace("-", "")


def test_local_exact_substring():
    pairs = [(b"TTTTACGTACGTTTT", b"GGGACGTACGGG")]
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, local=True
    )
    score, x, y = modes_end_cell(res, 0)
    assert score == 7 * 5  # longest common substring "ACGTACG"
    dirs = np.asarray(res.dirs)
    a1, a2, sy, sx = local_affine_traceback_pair(dirs[:, 0, :], x, y, *pairs[0])
    assert a1 == a2  # exact match segment


def test_gotoh_aligner_mode_dispatch():
    q = Record(b"ACGTACGT", b">q")
    d = Record(b"TTACGTACGTTT", b">d")
    # compat: reference parity
    r = get_aligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.SEMI_GLOBAL)).align_pair(q, d)
    assert r.error == "not implemented"
    # textbook: implemented
    r2 = get_aligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.SEMI_GLOBAL, compat=False)
    ).align_pair(q, d)
    assert r2.ok and r2.score == 40  # 8 matches, free end gaps
    r3 = get_aligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.LOCAL, compat=False)
    ).align_pair(q, d)
    assert r3.ok and r3.score == 40


def test_modes_pallas_matches_lax():
    """The plain modes fill at the removed kernel test's shapes: every end
    cell's score equals the brute force, in both modes."""
    import random

    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_affine_modes import nw_affine_modes_batch

    rng = random.Random(77)
    pairs = []
    for _ in range(8):
        n1 = rng.randint(1, 40)
        n2 = rng.randint(1, 40)
        pairs.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    batch = pack_batch(pairs, batch_size=8)
    for local in (False, True):
        rl = nw_affine_modes_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            local=local,
        )
        d_total = batch.query.shape[1] + batch.db.shape[1] + 1
        assert np.asarray(rl.dirs).shape[0] == -(-d_total // 4)
        mode = "local" if local else "semi"
        for b, (s1, s2) in enumerate(pairs):
            assert int(rl.best[b]) == brute_force_mode(s1, s2, mode), b


def test_modes_chunked_drain_equals_unchunked(monkeypatch):
    """A modes batch over the dirs-HBM budget fills in drained
    sub-batches with identical results (the textbook-modes analog of the
    global path's co-optimal chunking)."""
    import random

    from sequencealigning_tpu.config import AlignConfig, Mode
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models.gotoh import GotohAligner

    rng = random.Random(5)
    pairs = [
        (
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(4, 20))),
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(4, 20))),
        )
        for _ in range(12)
    ]
    recs = [
        (Record(seq=a, name=b">q"), Record(seq=b, name=b">d"))
        for a, b in pairs
    ]
    cfg = AlignConfig(mode=Mode.SEMI_GLOBAL, compat=False)
    want = GotohAligner(cfg).align_batch(recs)
    monkeypatch.setattr(GotohAligner, "dirs_hbm_budget", 200_000)
    a = GotohAligner(cfg)
    # sanity: the tiny budget actually forces multiple sub-batches
    from sequencealigning_tpu.io.encode import pack_batch

    assert a._dirs_chunks(pack_batch(pairs, 16), 12, per_byte=1.0) > 1
    got = a.align_batch(recs)
    for g, w in zip(got, want):
        assert g.score == w.score
        assert g.aligned_query == w.aligned_query
        assert g.aligned_db == w.aligned_db
