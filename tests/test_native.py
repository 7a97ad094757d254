"""Native C components: byte-equality with the Python reference paths."""

import random

import numpy as np
import pytest

from sequencealigning_tpu import native
from sequencealigning_tpu.errors import AlignmentError, CharError
from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops.nw_affine import nw_affine_batch
from sequencealigning_tpu.ops.traceback import traceback_pair

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _python_parse(contents):
    import os

    os.environ["SEQALIGN_NO_NATIVE"] = "1"
    try:
        from sequencealigning_tpu.io.fasta import parse_bytes

        try:
            r = parse_bytes(contents)
            return [(rec.seq, rec.name) for rec in r.records], []
        except CharError as e:
            return [(rec.seq, rec.name) for rec in e.res.records], e.chars
    finally:
        del os.environ["SEQALIGN_NO_NATIVE"]


@pytest.mark.parametrize(
    "contents",
    [
        b">R1\nACGT\n>R2\nTTNN\n",
        b">Record1\nATGCATGCATGCATGCATGCATGCATGC\nRecord2\nATGCATGCGTGCAGTGACCACA",
        b">Record1\nATGCATGCAKGCATGCATGCANNNGCATGC",
        b"leading garbage\n>R\nAC\nGT\n",
        b"",
        b">",
        b">name only",
        b">a\n\n\n>b\nNNNN",
    ],
)
def test_fasta_scan_matches_python(contents):
    got = native.fasta_scan_native(contents)
    assert got is not None
    exp_records, exp_errs = _python_parse(contents)
    assert got[0] == exp_records
    assert got[1] == exp_errs


def test_fasta_scan_random_fuzz():
    rng = random.Random(79)
    for _ in range(50):
        n = rng.randint(0, 200)
        contents = bytes(
            rng.choice(b"ACGTN>\nacgtxK 123") for _ in range(n)
        )
        got = native.fasta_scan_native(contents)
        exp = _python_parse(contents)
        assert got[0] == exp[0], contents
        assert got[1] == exp[1], contents


@pytest.mark.parametrize("compat", [True, False])
def test_native_first_path_matches_python(compat):
    rng = random.Random(83)
    pairs = []
    for _ in range(8):
        n1 = rng.randint(2, 30)
        n2 = rng.randint(2, 30)
        pairs.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    batch = pack_batch(pairs, batch_size=8)
    res = nw_affine_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat,
    )
    dirs = np.asarray(res.dirs)
    finals = np.asarray(res.finals)
    for b, (s1, s2) in enumerate(pairs):
        try:
            score, alns = traceback_pair(
                dirs[:, b, :], finals[b], s1, s2, compat=compat,
                max_alignments=1,
            )
            exp = ("ok", alns[0])
        except AlignmentError:
            exp = ("panic", None)
        try:
            ops = native.gotoh_first_path_native(
                dirs[:, b, :], finals[b], len(s1), len(s2), compat
            )
            from sequencealigning_tpu.ops.traceback import _apply_ops

            got = ("ok", _apply_ops(ops, s1, s2))
        except AlignmentError:
            got = ("panic", None)
        assert exp == got, (b, s1, s2)


def test_native_wfa_compat_matches_python_oracle():
    """Fuzz the C compat-WFA against the Python oracle: identical scores,
    alignments, and error messages on random pairs (including provable
    non-convergence and traceback-panic cases)."""
    import random

    import pytest

    from sequencealigning_tpu import native
    from sequencealigning_tpu.config import WfaPenalties, WfaPruning
    from sequencealigning_tpu.errors import AlignmentError
    from sequencealigning_tpu.ops import oracle_wfa

    if not native.available():
        pytest.skip("native library unavailable")

    rng = random.Random(77)
    pen, pru = WfaPenalties(), WfaPruning()

    def py(s1, s2):
        try:
            score, ocean = oracle_wfa.wfa_align(
                s1, s2, penalties=pen, pruning=pru, max_steps=20_000
            )
            a1, a2 = oracle_wfa.wfa_traceback(ocean, s1, s2)
            return (score, a1, a2)
        except AlignmentError as e:
            return ("err", str(e))

    def nat(s1, s2):
        try:
            r = native.wfa_compat_align_native(s1, s2, pen, pru, 20_000)
            assert r is not None
            return r
        except AlignmentError as e:
            return ("err", str(e))

    def cases():
        for _ in range(60):  # independent random pairs
            n1 = rng.randint(1, 28)
            n2 = rng.randint(1, 28)
            yield (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        for _ in range(20):  # mutated copies: deep oceans, trim active
            n = rng.randint(20, 60)
            ref = bytes(rng.choice(b"ACGT") for _ in range(n))
            mut = bytearray(ref)
            for _ in range(rng.randint(1, 4)):
                p_ = rng.randrange(n)
                mut[p_] = rng.choice([c for c in b"ACGT" if c != mut[p_]])
            yield (bytes(mut), ref)

    checked_conv = checked_err = 0
    for s1, s2 in cases():
        expect = py(s1, s2)
        got = nat(s1, s2)
        assert got == expect, (s1, s2, expect, got)
        if expect[0] == "err":
            checked_err += 1
        else:
            checked_conv += 1
    # Ensure the fuzz covered both regimes.
    assert checked_conv >= 5 and checked_err >= 5, (checked_conv, checked_err)


def test_native_fast4_walker_matches_python():
    import os
    import random

    import numpy as np
    import pytest

    from sequencealigning_tpu import native
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_affine_stream import nw_affine_stream_batch
    from sequencealigning_tpu.ops.traceback import traceback_stream_batch

    if not native.available():
        pytest.skip("native library unavailable")

    rng = random.Random(91)
    pairs = [
        (
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(2, 20))),
            bytes(rng.choice(b"ACGT") for _ in range(rng.randint(2, 20))),
        )
        for _ in range(24)
    ]
    batch = pack_batch(pairs, batch_size=24)
    res = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        with_dirs="fast4", backend="lax", np_slots=3,
    )
    args = (
        np.asarray(res.dirs), res.finals,
        [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
    )
    nat = traceback_stream_batch(*args, dirs_mode="fast4")
    os.environ["SEQALIGN_NO_NATIVE"] = "1"
    try:
        py = traceback_stream_batch(*args, dirs_mode="fast4")
    finally:
        del os.environ["SEQALIGN_NO_NATIVE"]
    norm = lambda xs: [
        (type(x).__name__, str(x)) if isinstance(x, Exception) else x
        for x in xs
    ]
    assert norm(nat) == norm(py)


def test_native_wfa_colliding_penalties_match_python():
    """Penalty-value collisions (x == e) make the Python oracle's if/elif
    dispatch shadow later branches; the C port must dispatch by value the
    same way."""
    import random

    import pytest

    from sequencealigning_tpu import native
    from sequencealigning_tpu.config import WfaPenalties, WfaPruning
    from sequencealigning_tpu.errors import AlignmentError
    from sequencealigning_tpu.ops import oracle_wfa

    if not native.available():
        pytest.skip("native library unavailable")

    rng = random.Random(113)
    pen = WfaPenalties(mismatch=6, gap_open=2, gap_extend=6)  # x == e
    pru = WfaPruning()

    def norm(fn, s1, s2):
        try:
            return fn(s1, s2)
        except AlignmentError as e:
            return ("err", str(e))

    def py(s1, s2):
        score, ocean = oracle_wfa.wfa_align(
            s1, s2, penalties=pen, pruning=pru, max_steps=20_000
        )
        a1, a2 = oracle_wfa.wfa_traceback(ocean, s1, s2)
        return (score, a1, a2)

    def nat(s1, s2):
        r = native.wfa_compat_align_native(s1, s2, pen, pru, 20_000)
        assert r is not None
        return r

    for _ in range(40):
        n1 = rng.randint(1, 24)
        n2 = rng.randint(1, 24)
        s1 = bytes(rng.choice(b"ACGT") for _ in range(n1))
        s2 = bytes(rng.choice(b"ACGT") for _ in range(n2))
        assert norm(nat, s1, s2) == norm(py, s1, s2), (s1, s2)


def test_native_banded_fast4_walker_matches_python():
    """The C banded fast4 walker must emit byte-identical alignments to the
    Python walker on random banded fills."""
    import random

    import numpy as np
    import pytest

    from sequencealigning_tpu import native
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_banded import nw_banded_batch
    from sequencealigning_tpu.ops.traceback import (
        banded_fast4_traceback_batch,
        banded_fast4_traceback_pair,
    )

    if not native.available():
        pytest.skip("native library unavailable")
    rng = random.Random(101)
    pairs = []
    for _ in range(8):
        n1 = rng.randint(2, 60)
        n2 = rng.randint(max(2, n1 - 8), n1 + 8)
        pairs.append(
            (
                bytes(rng.choice(b"ACGT") for _ in range(n1)),
                bytes(rng.choice(b"ACGT") for _ in range(n2)),
            )
        )
    batch = pack_batch(pairs, batch_size=8)
    res = nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        band=16, with_dirs="fast4",
    )
    dirs = np.asarray(res.dirs)
    finals = np.asarray(res.finals)
    got = banded_fast4_traceback_batch(
        dirs, finals, [p[0] for p in pairs], [p[1] for p in pairs], res.k_lo
    )
    for b, (s1, s2) in enumerate(pairs):
        exp = banded_fast4_traceback_pair(
            dirs[:, b, :], finals[b], s1, s2, res.k_lo
        )
        assert not isinstance(got[b], Exception)
        assert got[b] == exp, b


def test_native_wfa_textbook_traceback_matches_python():
    """The C textbook-WFA walker must emit byte-identical alignments to
    the Python walker over the same offset log."""
    import os
    import random

    import pytest

    from sequencealigning_tpu import native
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.wfa import wfa_textbook_batch, wfa_traceback_host

    if not native.available():
        pytest.skip("native library unavailable")
    rng = random.Random(113)
    pairs = []
    for _ in range(8):
        n = rng.randint(20, 120)
        s1l = [rng.choice("ACGT") for _ in range(n)]
        s2l = list(s1l)
        for _ in range(rng.randint(1, 6)):
            p = rng.randrange(n)
            s2l[p] = rng.choice("ACGT")
        if rng.random() < 0.5:
            del s2l[rng.randrange(len(s2l)) :][:3]
        pairs.append(("".join(s1l).encode(), "".join(s2l).encode()))
    batch = pack_batch(pairs, batch_size=8)
    res = wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=32
    )
    for b, (s1, s2) in enumerate(pairs):
        if not bool(res.converged[b]):
            continue
        got = wfa_traceback_host(res, b, s1, s2)
        os.environ["SEQALIGN_NO_NATIVE"] = "1"
        try:
            exp = wfa_traceback_host(res, b, s1, s2)
        finally:
            del os.environ["SEQALIGN_NO_NATIVE"]
        assert got == exp, b


def test_astar_native_matches_python_oracle():
    """The C weighted-A* must be byte-identical to the Python oracle --
    same score AND same alignment, i.e. the same Rust-BinaryHeap pop
    order (ties resolved by the parent-chain Ord)."""
    import random

    from sequencealigning_tpu import native
    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.ops.oracle_astar import astar_align

    if not native.available():
        pytest.skip("native runtime unavailable")
    sch = ScoringScheme()
    rng = random.Random(7)
    n_checked = 0
    for trial in range(60):
        n1 = rng.randint(1, 28)
        n2 = rng.randint(1, 28)
        s1 = bytes(rng.choice(b"ACGTN") for _ in range(n1))
        if trial % 3 == 0:
            s2 = bytes(rng.choice(b"ACGTN") for _ in range(n2))
        else:
            s2 = bytearray(s1)
            for _ in range(rng.randint(0, 3)):
                s2[rng.randrange(n1)] = rng.choice(b"ACGT")
            s2 = bytes(s2)
        semi = trial % 4 == 0
        want = astar_align(s1, s2, scheme=sch, semi_global=semi)
        got = native.astar_align_native(
            s1, s2, sch.match_, sch.mismatch, sch.gap_open,
            sch.gap_extend, sch.epsilon, semi_global=semi,
        )
        assert got == want, (trial, s1, s2, semi, got, want)
        n_checked += 1
    assert n_checked == 60


def test_astar_native_error_parity():
    from sequencealigning_tpu import native
    from sequencealigning_tpu.errors import AlignmentError

    if not native.available():
        pytest.skip("native runtime unavailable")
    from sequencealigning_tpu.config import ScoringScheme

    sch = ScoringScheme()
    with pytest.raises(AlignmentError, match="empty"):
        native.astar_align_native(
            b"", b"ACGT", sch.match_, sch.mismatch, sch.gap_open,
            sch.gap_extend, sch.epsilon,
        )
    with pytest.raises(AlignmentError, match="max_expansions"):
        native.astar_align_native(
            b"ACGT" * 8, b"TTTTGGGG" * 4, sch.match_, sch.mismatch,
            sch.gap_open, sch.gap_extend, sch.epsilon,
            max_expansions=10,
        )


def test_astar_batch_native_matches_singles():
    import random

    from sequencealigning_tpu import native
    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.ops.oracle_astar import astar_align

    if not native.available():
        pytest.skip("native runtime unavailable")
    sch = ScoringScheme()
    rng = random.Random(31)
    s1s, s2s = [], []
    for _ in range(24):
        n = rng.randint(1, 30)
        s1s.append(bytes(rng.choice(b"ACGTN") for _ in range(n)))
        s2s.append(bytes(rng.choice(b"ACGTN") for _ in range(rng.randint(1, 30))))
    s1s.append(b"")  # empty-input parity
    s2s.append(b"ACGT")
    got = native.astar_align_batch_native(
        s1s, s2s, sch.match_, sch.mismatch, sch.gap_open,
        sch.gap_extend, sch.epsilon,
    )
    for b in range(24):
        want = astar_align(s1s[b], s2s[b], scheme=sch)
        assert got[b] == want, (b, s1s[b], s2s[b])
    assert got[24] == (
        "One of the provided sequences was empty. Alignment is skipped"
    )


def test_native_wfa_compat_odd_penalties_match_python():
    """Odd (gcd-1) penalties make rec_tr's predecessor probes HIT (at
    the defaults every probe misses and alignments print empty --
    oracle_wfa.py analysis), so this fuzz is what actually exercises the
    traceback's branch dispatch (wfa.rs:683-853) in both independent
    emulations: the Python oracle and the C port must agree on scores,
    (buggy-faithful) alignments, and error strings."""
    import random

    import pytest

    from sequencealigning_tpu import native
    from sequencealigning_tpu.config import WfaPenalties, WfaPruning
    from sequencealigning_tpu.errors import AlignmentError
    from sequencealigning_tpu.ops import oracle_wfa

    if not native.available():
        pytest.skip("native library unavailable")

    rng = random.Random(31)
    pru = WfaPruning()
    for pen in (
        WfaPenalties(mismatch=5, gap_open=3, gap_extend=1),
        WfaPenalties(mismatch=3, gap_open=1, gap_extend=2),
    ):

        def py(s1, s2):
            try:
                score, ocean = oracle_wfa.wfa_align(
                    s1, s2, penalties=pen, pruning=pru, max_steps=20_000
                )
                a1, a2 = oracle_wfa.wfa_traceback(ocean, s1, s2)
                return (score, a1, a2)
            except AlignmentError as e:
                return ("err", str(e))

        def nat(s1, s2):
            try:
                r = native.wfa_compat_align_native(s1, s2, pen, pru, 20_000)
                assert r is not None
                return r
            except AlignmentError as e:
                return ("err", str(e))

        def cases():
            for _ in range(30):  # independent, length-skewed (gap-heavy)
                n1 = rng.randint(1, 24)
                n2 = rng.randint(1, 24)
                yield (
                    bytes(rng.choice(b"ACGT") for _ in range(n1)),
                    bytes(rng.choice(b"ACGT") for _ in range(n2)),
                )
            for _ in range(20):  # mutated copies incl. indels
                n = rng.randint(8, 40)
                ref = bytes(rng.choice(b"ACGT") for _ in range(n))
                mut = bytearray(ref)
                for _ in range(rng.randint(1, 4)):
                    i = rng.randrange(max(1, len(mut)))
                    op = rng.randrange(3)
                    if op == 0:
                        mut[i] = rng.choice(b"ACGT")
                    elif op == 1 and len(mut) > 3:
                        del mut[i]
                    else:
                        mut.insert(i, rng.choice(b"ACGT"))
                yield bytes(mut), ref

        n_nonempty = 0
        for s1, s2 in cases():
            a, b = py(s1, s2), nat(s1, s2)
            assert a == b, (pen, s1, s2, a, b)
            if a[0] != "err" and (a[1] or a[2]):
                n_nonempty += 1
        # The point of odd penalties: the probes must actually hit on a
        # decent share of pairs (at the even defaults ALL tracebacks
        # print empty; gap-heavy pairs are where the branches fire).
        assert n_nonempty > 5, (pen, n_nonempty)
