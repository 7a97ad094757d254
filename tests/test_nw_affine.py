"""Plain affine-NW fill tests: lax path vs oracle, traceback."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.errors import AlignmentError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.ops.nw_affine import nw_affine_batch
from sequencealigning_tpu.ops.traceback import traceback_batch


def _random_pairs(seed, n_pairs=8, lo=2, hi=30, alphabet=b"ACGT"):
    rng = random.Random(seed)
    return [
        (
            bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
            bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
        )
        for _ in range(n_pairs)
    ]


def _finals_vs_oracle(pairs, compat):
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat,
    )
    finals = np.asarray(res.finals)
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        exp = (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))
        got = tuple(int(v) for v in finals[b])
        assert exp == got, (b, s1, s2, exp, got)
    return res, batch


@pytest.mark.parametrize("compat", [True, False])
def test_lax_finals_match_oracle(compat):
    _finals_vs_oracle(_random_pairs(7, alphabet=b"ACGTN"), compat)


@pytest.mark.parametrize("compat", [True, False])
def test_pallas_interpret_matches_lax(compat):
    """The plain fill (the only engine of runner kernel='plain') at the
    removed kernel test's shapes: finals and dirs-word count."""
    pairs = _random_pairs(11, n_pairs=8, hi=25)
    res, batch = _finals_vs_oracle(pairs, compat)
    d_total = batch.query.shape[1] + batch.db.shape[1] + 1
    assert np.asarray(res.dirs).shape[0] == -(-d_total // 4)


@pytest.mark.parametrize("compat", [True, False])
def test_traceback_matches_oracle_walker(compat):
    pairs = _random_pairs(13 if compat else 17)
    res, batch = _finals_vs_oracle(pairs, compat)
    tb = traceback_batch(
        res.dirs, res.finals,
        [p[0] for p in pairs], [p[1] for p in pairs], compat=compat,
    )
    for b, (s1, s2) in enumerate(pairs):
        try:
            exp = oracle_gotoh.gotoh_traceback_all(s1, s2, compat=compat)
        except AlignmentError:
            exp = "ERR"
        got = tb[b] if not isinstance(tb[b], AlignmentError) else "ERR"
        assert exp == got, (b, s1, s2)


def test_score_only_mode():
    pairs = _random_pairs(19)
    batch = pack_batch(pairs, batch_size=8)
    r = nw_affine_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        with_dirs=False,
    )
    assert r.dirs is None
    for b, (s1, s2) in enumerate(pairs):
        assert int(np.asarray(r.finals)[b].max()) == oracle_gotoh.gotoh_score(s1, s2)


def test_wildcard_scoring():
    """wildcard=True gives the A*-style N-matches-anything rule."""
    batch = pack_batch([(b"NNNN", b"ACGT")], batch_size=8)
    r = nw_affine_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        wildcard=True,
    )
    assert int(np.asarray(r.finals)[0].max()) == 20


def test_variable_lengths_in_one_batch():
    """Finals must be read at each pair's own corner despite shared padding."""
    pairs = [(b"A", b"A"), (b"ACGTACGT", b"ACGTACGT"), (b"AC", b"ACGTACGTACGT")]
    _finals_vs_oracle(pairs, True)
