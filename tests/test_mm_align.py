"""Myers-Miller divide-and-conquer alignment: exact textbook score on
random pairs/schemes, linear memory, valid reconstruction."""

import random

import pytest

from sequencealigning_tpu.config import ScoringScheme
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.ops.mm_align import mm_align, mm_score_ops
from sequencealigning_tpu.ops.traceback import _apply_ops


@pytest.mark.parametrize("seed", [3, 5, 11])
def test_mm_matches_oracle_random(seed):
    rng = random.Random(seed)
    for trial in range(12):
        n1 = rng.randint(1, 45)
        n2 = rng.randint(1, 45)
        s1 = bytes(rng.choice(b"ACGT") for _ in range(n1))
        s2 = bytes(rng.choice(b"ACGT") for _ in range(n2))
        # Random schemes restricted to where the standard affine model
        # coincides with the reference's M-only-opens model (see
        # ops.mm_align docstring): mismatch >= 2*(open+ext) and >= 2*ext.
        ov = -rng.randint(0, 12)
        ev = -rng.randint(1, 7)
        bound = max(1, min(-2 * (ov + ev), -2 * ev))
        sch = ScoringScheme() if trial % 2 == 0 else ScoringScheme(
            match_=rng.randint(1, 8), mismatch=-rng.randint(1, bound),
            gap_open=ov, gap_extend=ev,
        )
        ops = mm_align(s1, s2, sch)
        assert mm_score_ops(ops, s1, s2, sch) == oracle_gotoh.gotoh_score(
            s1, s2, scheme=sch, compat=False
        ), (seed, trial, s1, s2, sch)
        a1, a2 = _apply_ops(ops, s1, s2)
        assert a1.replace("-", "").encode() == s1
        assert a2.replace("-", "").encode() == s2


def test_mm_structured_gaps():
    """Large indels (the band-escape shape class) reconstruct exactly."""
    sch = ScoringScheme()
    cases = [
        (b"G" * 60 + b"A" * 40, b"A" * 40),
        (b"A" * 40, b"G" * 60 + b"A" * 40),
        (b"ACGT" * 30, b"ACGT" * 10 + b"TTTT" * 5 + b"ACGT" * 20),
        (b"A", b"C" * 30),
        (b"C" * 30, b"A"),
    ]
    for s1, s2 in cases:
        ops = mm_align(s1, s2, sch)
        assert mm_score_ops(ops, s1, s2, sch) == oracle_gotoh.gotoh_score(
            s1, s2, scheme=sch, compat=False
        ), (s1[:10], s2[:10])


def test_mm_medium_vs_oracle():
    """A few-hundred-bp pair exercises several recursion levels."""
    rng = random.Random(29)
    n = 400
    s1 = bytes(rng.choice(b"ACGT") for _ in range(n))
    s2l = bytearray(s1)
    del s2l[100:160]
    for i in range(0, len(s2l), 23):
        s2l[i] = rng.choice(b"ACGT")
    s2 = bytes(s2l)
    sch = ScoringScheme()
    ops = mm_align(s1, s2, sch)
    assert mm_score_ops(ops, s1, s2, sch) == oracle_gotoh.gotoh_score(
        s1, s2, scheme=sch, compat=False
    )


def test_mm_is_a_relaxation_and_the_model_gate_catches_divergence():
    """Under schemes where adjacent cross-direction gap runs are
    profitable, the standard-model mm score exceeds the reference-model
    optimum; the model layer's rescoring gate must then degrade to
    score-only rather than claim a wrong alignment."""
    sch = ScoringScheme(match_=5, mismatch=-100, gap_open=-1, gap_extend=-1)
    s1, s2 = b"AA", b"TT"
    ops = mm_align(s1, s2, sch)
    assert mm_score_ops(ops, s1, s2, sch) > oracle_gotoh.gotoh_score(
        s1, s2, scheme=sch, compat=False
    )

    import dataclasses

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.models.gotoh import GotohAligner

    al = GotohAligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, scoring=sch, compat=False)
    )
    exact = oracle_gotoh.gotoh_score(s1, s2, scheme=sch, compat=False)
    r = al._mm_fallback((s1, s2), exact)
    assert r["score"] == exact
    assert r["aligned_query"] is None


def test_mm_forced_recursion_above_cutoff():
    """3k x 2.1k with a 900-long deletion: the problem exceeds the
    direct-solve cutoff, exercising joins + subsidized leaves together."""
    import numpy as np

    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_affine import nw_affine_batch

    rng = np.random.default_rng(9)
    conv = np.frombuffer(b"ACGT", np.uint8)
    n = 3000
    a = rng.integers(0, 4, n)
    s1 = bytes(conv[a])
    b = np.concatenate([a[:1000], a[1900:]])
    idx = rng.random(len(b)) < 0.03
    b[idx] = rng.integers(0, 4, idx.sum())
    s2 = bytes(conv[b])
    sch = ScoringScheme()
    ops = mm_align(s1, s2, sch)
    batch = pack_batch([(s1, s2)], batch_size=8)
    exact = int(
        np.asarray(
            nw_affine_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                compat=False, with_dirs=False,
            ).finals
        )[0].max()
    )
    assert mm_score_ops(ops, s1, s2, sch) == exact


def test_mm_device_rows_path_equals_direct_path(monkeypatch):
    """Force deep recursion (tiny direct-solve cutoff) and check the
    device-rows path produces equally-scoring alignments as the
    direct-DP path on the same inputs."""
    import sequencealigning_tpu.ops.mm_align as mm

    rng = random.Random(23)
    for _ in range(6):
        n1 = rng.randint(8, 60)
        n2 = rng.randint(8, 60)
        s1 = bytes(rng.choice(b"ACGT") for _ in range(n1))
        s2 = bytes(rng.choice(b"ACGT") for _ in range(n2))
        sch = ScoringScheme()
        direct = mm_score_ops(mm_align(s1, s2, sch), s1, s2, sch)
        monkeypatch.setattr(mm, "_DIRECT_CELLS", 32)
        deep = mm_score_ops(mm_align(s1, s2, sch), s1, s2, sch)
        monkeypatch.undo()
        assert direct == deep == oracle_gotoh.gotoh_score(
            s1, s2, scheme=sch, compat=False
        ), (s1, s2)
