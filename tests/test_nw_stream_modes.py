"""Streamed-pair semi-global/local fills vs the plain modes engine."""

import numpy as np
import pytest

from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops.nw_affine_modes import (
    modes_end_cell,
    nw_affine_modes_batch,
)
from sequencealigning_tpu.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch,
    stream_modes_best,
)
from sequencealigning_tpu.ops.traceback import (
    local_affine_traceback_pair,
    semi_global_traceback_pair,
)
from tests.test_affine_modes import (
    _pairs,
    _score_of_alignment,
    brute_force_mode,
)


@pytest.mark.parametrize("mode", ["semi", "local"])
@pytest.mark.parametrize("np_slots", [2, 3])
def test_stream_modes_match_plain_engine(mode, np_slots):
    # 16 pairs / np_slots=2|3 exercises multi-slot rows (pair
    # pipelining), 3 with a padded last row.
    pairs = _pairs(211 if mode == "semi" else 223, n=16, lo=2, hi=12)
    batch = pack_batch(pairs, batch_size=16)
    res = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=np_slots,
    )
    plain = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        local=(mode == "local"),
    )
    for b, (s1, s2) in enumerate(pairs):
        score, x, y = stream_modes_best(res, b)
        p_score, p_x, p_y = modes_end_cell(plain, b)
        assert score == p_score, (b, s1, s2, score, p_score)
        assert (x, y) == (p_x, p_y), (b, x, y, p_x, p_y)
        assert score == brute_force_mode(s1, s2, mode)


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_stream_modes_pallas_matches_lax_bitexact(mode):
    """At the removed kernel test's shapes: end cells equal the brute
    force, and a score-only fill gives the same end cells."""
    pairs = _pairs(227, n=16, lo=2, hi=12)
    batch = pack_batch(pairs, batch_size=16)
    lax = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=2,
    )
    nod = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=2, with_dirs=False,
    )
    assert nod.dirs is None
    assert np.array_equal(lax.best, nod.best)
    assert np.array_equal(lax.best_x, nod.best_x)
    assert np.array_equal(lax.best_y, nod.best_y)
    for b, (s1, s2) in enumerate(pairs):
        assert int(lax.best[b]) == brute_force_mode(s1, s2, mode), b


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_stream_modes_traceback_from_streamed_dirs(mode):
    pairs = _pairs(229, n=8, lo=3, hi=14)
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=2,
    )
    dirs = np.asarray(res.dirs)
    plan = res.plan
    for b, (s1, s2) in enumerate(pairs):
        score, x, y = stream_modes_best(res, b)
        row, slot, d_off = plan.pair_coords(b)
        dirs_b = dirs[:, row, :]
        if mode == "semi":
            a1, a2 = semi_global_traceback_pair(
                dirs_b, x, y, s1, s2, d_offset=d_off
            )
            assert a1.replace("-", "") == s1.decode()
            assert a2.replace("-", "") == s2.decode()
            assert _score_of_alignment(a1, a2, semi=True) == score
        else:
            a1, a2, sy, sx = local_affine_traceback_pair(
                dirs_b, x, y, s1, s2, d_offset=d_off
            )
            assert _score_of_alignment(a1, a2) == score, (b, s1, s2, a1, a2)
            seg1 = a1.replace("-", "")
            seg2 = a2.replace("-", "")
            assert s1.decode()[sy : sy + len(seg1)] == seg1
            assert s2.decode()[sx : sx + len(seg2)] == seg2


@pytest.mark.parametrize("mode_name", ["semi-global", "local"])
def test_model_layer_streamed_routing_matches_plain(mode_name):
    """>=32-pair textbook modes batches route to the streamed engine; the
    results must equal the plain engine's pair for pair."""
    from sequencealigning_tpu.config import AlignConfig, Algo, Mode
    from sequencealigning_tpu.models import get_aligner

    mode = Mode.SEMI_GLOBAL if mode_name == "semi-global" else Mode.LOCAL
    pairs = _pairs(233, n=33, lo=2, hi=12)  # 33 > routing threshold
    al = get_aligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=mode, compat=False)
    )
    big = al._align_batch_impl(pairs)           # streamed route
    small = []
    for chunk_start in range(0, len(pairs), 8):  # plain route (<32/call)
        small.extend(al._align_batch_impl(pairs[chunk_start:chunk_start + 8]))
    assert len(big) == len(small) == len(pairs)
    for b, (r_big, r_small) in enumerate(zip(big, small)):
        assert isinstance(r_big, dict) and isinstance(r_small, dict), b
        assert r_big["score"] == r_small["score"], b
        assert r_big["aligned_query"] == r_small["aligned_query"], b
        assert r_big["aligned_db"] == r_small["aligned_db"], b


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_stream_modes_skewed_lengths(mode):
    """Strongly unequal L1 vs L2 stresses the pipelined window geometry
    (launch period s = max(L1,L2)+1 >> the shorter side)."""
    import random

    rng = random.Random(241)
    pairs = []
    for _ in range(8):
        n1 = rng.randint(2, 6)
        n2 = rng.randint(20, 30)
        if rng.random() < 0.5:
            n1, n2 = n2, n1
        pairs.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=2,
    )
    plain = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        local=(mode == "local"),
    )
    for b, (s1, s2) in enumerate(pairs):
        score, x, y = stream_modes_best(res, b)
        p_score, p_x, p_y = modes_end_cell(plain, b)
        assert (score, x, y) == (p_score, p_x, p_y), (b, s1, s2)
        assert score == brute_force_mode(s1, s2, mode)


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_stream_modes_int16_state_matches_int32(mode):
    """int16 modes state: best-score/diag argmax buffers and walked
    alignments must equal int32's exactly (dirs bytes may differ only at
    never-walked sentinel-vs-sentinel flags, as in the global kernel)."""
    import jax.numpy as jnp

    pairs = _pairs(229, n=16, lo=2, hi=12)
    batch = pack_batch(pairs, batch_size=16)
    r32 = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=2,
    )
    r16 = nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        np_slots=2, state_dtype=jnp.int16,
    )
    assert np.array_equal(r32.best, r16.best)
    assert np.array_equal(r32.best_x, r16.best_x)
    assert np.array_equal(r32.best_y, r16.best_y)
    d32 = np.asarray(r32.dirs)
    d16 = np.asarray(r16.dirs)
    for b, (s1, s2) in enumerate(pairs):
        e32 = stream_modes_best(r32, b)
        e16 = stream_modes_best(r16, b)
        assert e32 == e16
        score, x, y = e32
        row, _slot, d_off = r32.plan.pair_coords(b)
        walk = (
            local_affine_traceback_pair
            if mode == "local"
            else semi_global_traceback_pair
        )
        w32 = walk(d32[:, row, :], x, y, s1, s2, d_offset=d_off)
        w16 = walk(d16[:, row, :], x, y, s1, s2, d_offset=d_off)
        assert w32 == w16, (mode, b, s1, s2)
