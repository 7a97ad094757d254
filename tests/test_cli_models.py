"""CLI + model-layer end-to-end tests."""

import json

import pytest

from sequencealigning_tpu.cli import main
from sequencealigning_tpu.config import AlignConfig, Algo, Mode
from sequencealigning_tpu.io.fasta import Record, Records
from sequencealigning_tpu.models import get_aligner


@pytest.fixture
def fasta_files(tmp_path):
    q = tmp_path / "q.fa"
    q.write_text(">q1\nACGTACGTAC\n")
    d = tmp_path / "db.fa"
    d.write_text(">db1\nACGTACGTACGT\n>db2\nACGTTACGTAC\n")
    return str(q), str(d)


def test_cli_nw_stdout_and_jsonl(fasta_files, tmp_path, capsys):
    q, d = fasta_files
    out = tmp_path / "res.jsonl"
    assert main(["-q", q, "-d", d, "-a", "needleman-wunsch", "-o", str(out)]) == 0
    captured = capsys.readouterr()
    assert "alignment found" in captured.out
    assert "seq1: ACGTACGTAC--" in captured.out
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 2
    # 10 matches + trailing 2-gap (interior D cells: o + 2e; the compat
    # extra-extend quirk applies only to leading/boundary chains)
    assert lines[0]["score"] == 50 - 8 - 12
    assert lines[0]["cigar"] == "10M2D"


def test_cli_astar(fasta_files, capsys):
    q, d = fasta_files
    assert main(["-q", q, "-d", d, "-a", "a-star", "--no-out"]) == 0
    out = capsys.readouterr().out
    assert "Alignment for db >db1 and query >q1 with score 30 found" in out


def test_cli_wfa_compat_isolates_nonconvergent(fasta_files, capsys):
    q, d = fasta_files
    assert main(["-q", q, "-d", d, "-a", "wfa", "--no-out"]) == 0
    err = capsys.readouterr().err
    assert "An error occured during alignment" in err


def test_cli_wfa_textbook(fasta_files, capsys):
    q, d = fasta_files
    assert main(["-q", q, "-d", d, "-a", "wfa", "--textbook", "--no-out"]) == 0
    out = capsys.readouterr().out
    assert "converged with score 14: " in out
    assert "converged with score 8: " in out


def test_cli_bad_extension(tmp_path, capsys):
    bad = tmp_path / "x.txt"
    bad.write_text(">r\nACGT\n")
    q = tmp_path / "q.fa"
    q.write_text(">q\nACGT\n")
    assert main(["-q", str(q), "-d", str(bad), "--no-out"]) == 1
    assert "aborting" in capsys.readouterr().err


def test_cli_char_recovery(tmp_path, capsys):
    q = tmp_path / "q.fa"
    q.write_text(">q\nACXGT\n")
    d = tmp_path / "d.fa"
    d.write_text(">d\nACGT\n")
    assert main(["-q", str(q), "-d", str(d), "-a", "needleman-wunsch", "--no-out"]) == 0
    err = capsys.readouterr().err
    assert "Invalid character" in err and "ignoring" in err


def test_mode_not_implemented_matches_reference(fasta_files):
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.LOCAL)
    aligner = get_aligner(config)
    r = aligner.align_pair(
        Record(seq=b"ACGT", name=b">a"), Record(seq=b"ACGT", name=b">b")
    )
    assert r.error == "not implemented"


def test_all_pairs_order(fasta_files):
    """Driver iterates db outer, query inner (main.rs:61-62)."""
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH)
    aligner = get_aligner(config)
    query = Records([Record(b"ACGT", b">q1"), Record(b"TTTT", b">q2")])
    db = Records([Record(b"ACGT", b">d1"), Record(b"GGGG", b">d2")])
    res = list(aligner.align_all_pairs(query, db))
    order = [(r.db_name, r.query_name) for r in res]
    assert order == [
        (">d1", ">q1"), (">d1", ">q2"), (">d2", ">q1"), (">d2", ">q2")
    ]


def test_empty_seq_isolation():
    """Empty query: A* errors with the reference's message, batch continues."""
    config = AlignConfig(algo=Algo.A_STAR)
    aligner = get_aligner(config)
    res = aligner.align_batch(
        [
            (Record(b"", b">e"), Record(b"ACGT", b">d")),
            (Record(b"ACGT", b">q"), Record(b"ACGT", b">d")),
        ]
    )
    assert not res[0].ok and "empty" in res[0].error
    assert res[1].ok and res[1].score == 20


def test_bucketed_all_pairs_same_results():
    """Length bucketing must not change results or their order."""
    import random

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record, Records
    from sequencealigning_tpu.models import get_aligner

    rng = random.Random(31)
    recs = Records(
        [
            Record(
                seq=bytes(rng.choice(b"ACGT") for _ in range(rng.randint(3, 40))),
                name=f">r{i}".encode(),
            )
            for i in range(7)
        ]
    )
    base_cfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, batch_size=4)
    plain = [
        (r.query_name, r.db_name, r.score, r.error)
        for r in get_aligner(base_cfg).align_all_pairs(recs, recs)
    ]
    bcfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, batch_size=4, bucket=True)
    bucketed = [
        (r.query_name, r.db_name, r.score, r.error)
        for r in get_aligner(bcfg).align_all_pairs(recs, recs)
    ]
    assert plain == bucketed


def test_result_json_includes_karlin_altschul_stats():
    import math

    from sequencealigning_tpu.config import AlignConfig, Algo, ScoringScheme
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.utils.stats import bit_score, e_value

    al = get_aligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    res = al.align_pair(
        Record(seq=b"ACGTACGT", name=b">q"), Record(seq=b"ACGTACGT", name=b">d")
    )
    d = res.to_json()
    assert math.isclose(d["e_value"], e_value(res.score, 8, 8))
    assert math.isclose(d["bit_score"], bit_score(res.score))
    # Identity alignment of 8 bp at +5/match: sanity-check the formulas.
    assert d["bit_score"] > 0
    # Karlin-Altschul constants are for local ungapped alignment; a
    # global-mode result must carry the approximate-domain label.
    assert d["stats_domain"] == "approx_global"


def test_gotoh_first_only_matches_score():
    import random

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner
    from sequencealigning_tpu.ops import oracle_gotoh

    rng = random.Random(53)
    al = get_aligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    )
    pairs = [
        (
            Record(
                seq=bytes(rng.choice(b"ACGT") for _ in range(rng.randint(3, 20))),
                name=b">q",
            ),
            Record(
                seq=bytes(rng.choice(b"ACGT") for _ in range(rng.randint(3, 20))),
                name=b">d",
            ),
        )
        for _ in range(12)
    ]
    for r, (q, d) in zip(al.align_batch(pairs), pairs):
        assert r.ok, r.error
        assert r.score == oracle_gotoh.gotoh_score(q.seq, d.seq)
        assert r.aligned_query.replace("-", "").encode() == q.seq


def test_gotoh_dirs_chunking_matches_unchunked(monkeypatch):
    """Over-budget co-optimal batches fill in drained sub-batches with
    identical results (round-1 gap: full dirs exceeded HBM at 4096 pairs)."""
    import random

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.models import get_aligner

    rng = random.Random(7)
    recs = [
        Record(
            seq=bytes(rng.choice(b"ACGT") for _ in range(rng.randint(5, 40))),
            name=f">r{i}".encode(),
        )
        for i in range(12)
    ]
    pairs = [(recs[i], recs[(i * 5 + 3) % 12]) for i in range(12)]
    al = get_aligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    plain = [
        (r.score, r.aligned_query, r.aligned_db, r.alignments)
        for r in al.align_batch(pairs)
    ]
    monkeypatch.setattr(type(al), "dirs_hbm_budget", 100_000)  # ~4 sub-batches
    chunked = [
        (r.score, r.aligned_query, r.aligned_db, r.alignments)
        for r in al.align_batch(pairs)
    ]
    assert plain == chunked


def test_cli_textbook_modes_streamed_route(tmp_path, capsys):
    """A >=32-pair textbook semi-global CLI run exercises the streamed
    modes engine end-to-end (parse -> model routing -> streamed fill ->
    walker -> JSONL), and each score equals the single-pair result."""
    import random

    rng = random.Random(5)
    qf = tmp_path / "q.fa"
    qf.write_text(
        "".join(
            f">q{i}\n"
            + "".join(rng.choice("ACGT") for _ in range(rng.randint(4, 14)))
            + "\n"
            for i in range(33)
        )
    )
    df = tmp_path / "d.fa"
    df.write_text(">d1\nACGTTACGGATCACGT\n")
    out = tmp_path / "res.jsonl"
    rc = main(
        [
            "-q", str(qf), "-d", str(df), "-a", "needleman-wunsch",
            "-m", "semi-global", "--textbook", "-o", str(out),
            "--batch-size", "64",
        ]
    )
    capsys.readouterr()
    assert rc == 0
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 33
    from sequencealigning_tpu.io.fasta import parse_fasta

    qs = parse_fasta(str(qf))
    al = get_aligner(
        AlignConfig(
            algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.SEMI_GLOBAL, compat=False
        )
    )
    d_seq = parse_fasta(str(df)).records[0]
    for rec, line in zip(qs.records, lines):
        single = al.align_pair(rec, d_seq)
        assert line["score"] == single.score, rec.name
        assert line["error"] is None


def test_cli_serve_mode(fasta_files, capsys, monkeypatch):
    """--serve: one JSON line per pair + a summary per request, per-request
    error isolation, warm aligner reuse across requests."""
    import io

    q, d = fasta_files
    monkeypatch.setattr(
        "sys.stdin",
        io.StringIO(
            f"{q} {d}\n"
            "# comment line\n"
            "\n"
            "nonexistent.fa also-missing.fa\n"
            f"{q} {d}\n"
        ),
    )
    rc = main(["--serve", "-a", "needleman-wunsch", "--first-only"])
    assert rc == 0
    out_lines = [
        json.loads(line)
        for line in capsys.readouterr().out.strip().splitlines()
    ]
    summaries = [o for o in out_lines if o.get("done")]
    errors = [o for o in out_lines if "error" in o and "score" not in o]
    results = [o for o in out_lines if "score" in o]
    assert len(summaries) == 2  # two successful requests, both summarized
    assert summaries[0]["pairs"] == summaries[1]["pairs"] == len(results) // 2
    assert any("opened" in e["error"] for e in errors)  # isolation
    assert all(r["cigar"] for r in results)


def test_cli_requires_files_without_serve(capsys):
    with pytest.raises(SystemExit):
        main(["-a", "needleman-wunsch"])


def test_parse_spans_rejects_non_integer_token():
    """--wfa-spans 10,x must exit with the usage message, not an
    uncaught ValueError traceback (ADVICE r4)."""
    import pytest

    from sequencealigning_tpu.cli import _parse_spans

    assert _parse_spans(None) is None
    assert _parse_spans("10") == (10, 10, 10, 10)
    assert _parse_spans("1,2,3,4") == (1, 2, 3, 4)
    for bad in ("10,x", "abc", "1,2,3", "-1", "1,2,3,4,5", ""):
        with pytest.raises(SystemExit, match="wfa-spans"):
            _parse_spans(bad)


def test_gotoh_first_only_runner_route_matches_legacy():
    """The r5 fused-runner batch route (first_only + device walk) must
    return exactly the legacy path's alignments (same kernel, same
    walker semantics; only the dispatch fusion differs)."""
    import dataclasses

    import numpy as np

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.models.gotoh import GotohAligner

    rng = np.random.default_rng(23)
    A = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(12):
        n = int(rng.integers(16, 70))
        s2 = rng.choice(A, n).tobytes()
        s1 = bytearray(s2)
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, max(1, len(s1))))
            op = int(rng.integers(0, 3))
            if op == 0 and len(s1):
                s1[i] = int(rng.choice(A))
            elif op == 1 and len(s1) > 3:
                del s1[i]
            else:
                s1.insert(i, int(rng.choice(A)))
        pairs.append((bytes(s1), s2))
    cfg = AlignConfig(
        algo=Algo.NEEDLEMAN_WUNSCH, first_only=True, traceback="device"
    )
    dev = GotohAligner(cfg)._align_batch_impl(pairs)
    host = GotohAligner(
        dataclasses.replace(cfg, traceback="host")
    )._align_batch_impl(pairs)
    assert len(dev) == len(host) == 12
    for a, b in zip(dev, host):
        assert isinstance(a, dict) and isinstance(b, dict), (a, b)
        assert a == b
