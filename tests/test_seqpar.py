"""Sequence parallelism: one pair's DP matrix sharded over the mesh's
devices (pipelined wavefront + ppermute boundary relay) must reproduce the
full Gotoh oracle exactly."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.parallel.mesh import make_mesh
from sequencealigning_tpu.parallel.seqpar import seqpar_fill


def _pairs(seed, n=8, n1_hi=200, n2_lo=300, n2_hi=900):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        n1 = rng.randint(1, n1_hi)
        n2 = rng.randint(n2_lo, n2_hi)
        out.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    return out


@pytest.mark.parametrize("compat", [True, False])
def test_seqpar_matches_oracle_across_devices(compat):
    mesh = make_mesh()
    pairs = _pairs(61)
    batch = pack_batch(pairs, batch_size=8)
    finals = seqpar_fill(
        batch.query, batch.db, batch.query_len, batch.db_len,
        mesh=mesh, tile_lanes=128, compat=compat,
    )
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in finals[b]) == exp, (b, s1, s2)


def test_seqpar_matches_tiled_single_device_engine():
    """Cross-check the two long-pair engines against each other on a batch
    with short and empty edges."""
    from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_batch

    pairs = _pairs(67, n=6, n2_lo=1, n2_hi=600) + [(b"", b"ACG"), (b"AC", b"")]
    batch = pack_batch(pairs, batch_size=8)
    sp = seqpar_fill(
        batch.query, batch.db, batch.query_len, batch.db_len,
        mesh=make_mesh(), tile_lanes=128,
    )
    ti = nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        tile_lanes=128,
    )
    assert np.array_equal(sp[: len(pairs)], ti[: len(pairs)])


@pytest.mark.parametrize("compat", [True, False])
def test_seqpar_chained_beyond_mesh_capacity(compat):
    """db longer than n_devices * tile_lanes chains rounds: the last
    device's boundary emissions seed the next round's device 0.  Pairs
    span >2x the 8 x 128-lane mesh capacity (3 rounds) with ragged
    lengths so corners land in every round; exact vs the Gotoh oracle
    (VERDICT r3 item 6)."""
    rng = random.Random(71)
    pairs = []
    for n2 in (2900, 2500, 1500, 1024, 1025, 900, 40, 2048):
        n1 = rng.randint(1, 120)
        pairs.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    batch = pack_batch(pairs, batch_size=8)
    finals = seqpar_fill(
        batch.query, batch.db, batch.query_len, batch.db_len,
        mesh=make_mesh(), tile_lanes=128, compat=compat,
    )
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        assert tuple(int(v) for v in finals[b]) == exp, (b, len(s1), len(s2))


def test_seqpar_align_certified_alignment():
    """seqpar_align (r5): mesh-sharded exact score + banded alignment
    certified against it.  Fuzzed pair long enough to chain rounds past
    the mesh capacity at tiny tile_lanes; score must equal the scalar
    oracle, the alignment must rescore to it and consume the sequences
    exactly."""
    import numpy as np

    from sequencealigning_tpu.ops import oracle_gotoh
    from sequencealigning_tpu.parallel.seqpar import seqpar_align

    rng = np.random.default_rng(29)
    A = np.frombuffer(b"ACGT", np.uint8)
    n = 1500
    s2 = rng.choice(A, n).tobytes()
    s1 = bytearray(s2)
    for _ in range(12):
        i = int(rng.integers(0, len(s1)))
        op = int(rng.integers(0, 3))
        if op == 0:
            s1[i] = int(rng.choice(A))
        elif op == 1 and len(s1) > 3:
            del s1[i]
        else:
            s1.insert(i, int(rng.choice(A)))
    s1 = bytes(s1)
    # tile_lanes 128 on the 8-device mesh: D * W = 1024 < 1500 lanes ->
    # the fill chains a second round (the capacity-chaining path).
    score, a1, a2 = seqpar_align(
        s1, s2, tile_lanes=128, compat=False, band=128
    )
    assert score == oracle_gotoh.gotoh_score(s1, s2, compat=False)
    assert a1.replace("-", "").encode() == s1
    assert a2.replace("-", "").encode() == s2
    # rescore (textbook affine, reference maximize convention)
    from sequencealigning_tpu.config import ScoringScheme

    sch = ScoringScheme()
    got, prev = 0, None
    for c1, c2 in zip(a1, a2):
        op = "D" if c1 == "-" else ("I" if c2 == "-" else "M")
        if op == "M":
            got += sch.match_ if c1 == c2 else sch.mismatch
        else:
            got += sch.gap_extend + (sch.gap_open if op != prev else 0)
        prev = op
    assert got == score


def test_seqpar_align_mm_fallback_past_band_cap():
    """An optimum needing a wider band than max_band falls to the exact
    Myers-Miller alignment, still certified by the mesh score."""
    from sequencealigning_tpu.ops import oracle_gotoh
    from sequencealigning_tpu.parallel.seqpar import seqpar_align

    s1 = b"ACGT" * 120
    s2 = b"T" * 400 + b"ACGT" * 120  # 400-long leading gap >> band 128
    score, a1, a2 = seqpar_align(
        s1, s2, tile_lanes=128, compat=False, band=128, max_band=128
    )
    assert score == oracle_gotoh.gotoh_score(s1, s2, compat=False)
    assert a1 is not None
    assert a1.replace("-", "").encode() == s1
    assert a2.replace("-", "").encode() == s2
