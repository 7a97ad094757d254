"""Randomized cross-validation: kernels vs oracles over many pairs.

The SURVEY §4 'implication' tests: cross-algorithm score agreement on
random pairs, at fuzz scale (fast CPU settings)."""

import random

import numpy as np
import pytest

from sequencealigning_tpu.config import ScoringScheme, WfaPenalties
from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu.ops.nw_affine_stream import nw_affine_stream_batch
from sequencealigning_tpu.ops.nw_banded import nw_banded_batch
from sequencealigning_tpu.ops.wfa import wfa_textbook_batch


def _pairs(seed, n, lo=1, hi=40, alphabet=b"ACGT"):
    rng = random.Random(seed)
    return [
        (
            bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
            bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
        )
        for _ in range(n)
    ]


@pytest.mark.parametrize("compat", [True, False])
def test_fuzz_stream_kernel_vs_oracle_96_pairs(compat):
    pairs = _pairs(101 + compat, 96)
    batch = trim_for_stream(pack_batch(pairs, batch_size=96))
    res = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat, with_dirs=False, np_slots=4,
    )
    for b, (s1, s2) in enumerate(pairs):
        exp = oracle_gotoh.gotoh_score(s1, s2, compat=compat)
        assert int(res.finals[b].max()) == exp, (b, s1, s2)


def test_fuzz_banded_wide_band_equals_full():
    pairs = _pairs(202, 32, lo=2, hi=24)
    batch = pack_batch(pairs, batch_size=32)
    res = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=32, with_dirs=False,
    )
    finals = np.asarray(res.finals)
    for b, (s1, s2) in enumerate(pairs):
        assert int(finals[b].max()) == oracle_gotoh.gotoh_score(s1, s2)


def test_fuzz_wfa_vs_gotoh_equivalence():
    pen = WfaPenalties()
    eq = ScoringScheme(
        match_=0, mismatch=-pen.mismatch,
        gap_open=-pen.gap_open, gap_extend=-pen.gap_extend,
    )
    pairs = _pairs(303, 24, lo=2, hi=20)
    batch = pack_batch(pairs, batch_size=24)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        penalties=pen, band=24, s_max=512,
    )
    conv = np.asarray(res.converged)
    scores = np.asarray(res.score)
    for b, (s1, s2) in enumerate(pairs):
        assert conv[b], (b, s1, s2)
        g = oracle_gotoh.gotoh_score(s1, s2, scheme=eq, compat=False)
        assert int(scores[b]) == -g, (b, s1, s2)


def test_random_scheme_engines_match_oracle():
    """Differential fuzz under randomized scoring schemes: every affine
    engine (plain, streamed, banded-wide, tiled) must equal the oracle for
    arbitrary (match, mismatch, open, extend) in both quirk modes."""
    import random

    import numpy as np

    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops import oracle_gotoh
    from sequencealigning_tpu.ops.nw_affine import nw_affine_batch
    from sequencealigning_tpu.ops.nw_affine_stream import nw_affine_stream_batch
    from sequencealigning_tpu.ops.nw_affine_tiled import nw_affine_tiled_batch
    from sequencealigning_tpu.ops.nw_banded import nw_banded_batch

    rng = random.Random(7)
    for trial in range(3):
        sch = ScoringScheme(
            match_=rng.randint(1, 10),
            mismatch=-rng.randint(1, 12),
            gap_open=-rng.randint(0, 15),
            gap_extend=-rng.randint(1, 9),
        )
        compat = trial % 2 == 0
        pairs = []
        for _ in range(8):
            n1 = rng.randint(1, 50)
            n2 = rng.randint(1, 50)
            pairs.append(
                (
                    bytes(rng.choice(b"ACGT") for _ in range(n1)),
                    bytes(rng.choice(b"ACGT") for _ in range(n2)),
                )
            )
        batch = pack_batch(pairs, batch_size=8)
        exp = []
        for s1, s2 in pairs:
            m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, scheme=sch, compat=compat)
            exp.append((int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1])))
        args = (batch.query, batch.db, batch.query_len, batch.db_len)
        engines = {
            "plain": np.asarray(
                nw_affine_batch(*args, scheme=sch, compat=compat,
                                with_dirs=False).finals
            ),
            "stream": np.asarray(
                nw_affine_stream_batch(*args, scheme=sch, compat=compat,
                                       with_dirs=False, backend="lax").finals
            ),
            "banded": np.asarray(
                nw_banded_batch(*args, band=64, scheme=sch, compat=compat,
                                with_dirs=False).finals
            ),
            "tiled": nw_affine_tiled_batch(
                *args, scheme=sch, compat=compat, tile_lanes=128,
            ),
        }
        for name, fin in engines.items():
            for b in range(8):
                assert tuple(int(v) for v in fin[b]) == exp[b], (
                    trial, name, b, sch,
                )
