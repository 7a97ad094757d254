#!/usr/bin/env python3
"""On-card smoke test: the aligner's main path on one NVIDIA GPU.

Runs BASELINE's five configurations at their stated sizes through the
normal entry points (GotohAligner, BandedAligner, WfaAligner,
LinearNWAligner, DataParallelRunner, stream_align, cli.main) with the CUDA
fills as compiled for the card, and checks every result with the repo's
own references: the scalar oracles (ops.oracle_*), the lax.scan twins bit
for bit, the native WFA engine, and a host rescoring of every CIGAR.  All
compared results are integers (scores, CIGARs, packed direction words):
tolerance 0.  No float matrix product is involved, so TF32 does not apply.

Each phase prints one line with its wall time, throughput and checks; a
failing check raises and the script exits non-zero.

    python chip_smoke.py           # one GPU, every phase
    python chip_smoke.py --four    # the multi-card paths on 4 GPUs, only

Where JAX finds no GPU it exits non-zero and prints no result.  The last
line of stdout is {"ok": true, "device": {...}}.  One process drives the
card; oracle checks run in CPU-only worker processes that never touch it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WORK = HERE / "build" / "chip_smoke"  # gitignored scratch (CLI phase)

# (pairs, length) of each phase: BASELINE's configurations at their sizes.
SIZES = dict(
    gotoh=(4096, 2046), gotoh_full=(64, 2046), banded=(1024, 5115),
    wfa=(128, 10230), stream=(2048, 1022), linear=(1, 1000), cli=(8, 2046),
    ab_stream=(1024, 2046), ab_banded=(1024, 5115), four=(4096, 2046),
    seqpar=(1, 20000), twin_sub=(256, 0), wfa_std=(32, 10230),
    wfa_wide=(8, 10230), wide_full=(8, 5115), wide_first=(64, 5115),
)

# Kernel-vs-twin variants: (dirs mode, compat) of the streamed fill and
# (dirs mode, compat, model) of the banded fill -- every branch of both
# CUDA kernels (fills.cu) at the phases' widths.
STREAM_VARIANTS = (
    ("fast4", True), ("full", True), (False, True),
    ("fast4", False), ("full", False),
)
BANDED_VARIANTS = (
    ("fast4", True, "ref"), ("full", True, "ref"), (False, True, "ref"),
    ("fast4", False, "ref"), ("full", False, "ref"),
    ("fast4", False, "std"), (False, False, "std"),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **kv) -> None:
    """The phase's one line."""
    parts = []
    for k, v in kv.items():
        parts.append(f"{k}={v!r}" if isinstance(v, float) else f"{k}={v}")
    print(f"[{phase}] " + " ".join(parts), flush=True)


def peak_gb() -> float:
    """Peak device memory the program's arrays took so far (GB)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def ready(x):
    import jax

    return jax.block_until_ready(x)


# ---------------------------------------------------------------------------
# CPU oracle workers (spawned processes; they never import a GPU backend)
# ---------------------------------------------------------------------------


def _oracle_job(job):
    os.environ["JAX_PLATFORMS"] = "cpu"
    kind, s1, s2 = job
    if kind == "gotoh_score":
        from sequencealigning_tpu.ops.oracle_gotoh import gotoh_score

        return gotoh_score(s1, s2)
    if kind == "gotoh_all":
        from sequencealigning_tpu.errors import AlignmentError
        from sequencealigning_tpu.ops.oracle_gotoh import gotoh_traceback_all

        try:
            return gotoh_traceback_all(s1, s2)
        except AlignmentError as e:
            return ("error", str(e))
    raise ValueError(kind)


def _records(pairs):
    from sequencealigning_tpu.io.fasta import Record

    return [
        (Record(seq=q, name=b">q%d" % i), Record(seq=d, name=b">d%d" % i))
        for i, (q, d) in enumerate(pairs)
    ]


def _rescored(results, compat=True) -> int:
    """Number of results whose alignment rescores to its score."""
    from sequencealigning_tpu.utils.rescore import affine_rescore

    return sum(
        1 for r in results
        if r.ok and r.aligned_query is not None
        and affine_rescore(r.aligned_query, r.aligned_db, compat=compat)
        == r.score
    )


# ---------------------------------------------------------------------------
# Kernel vs lax twin on identical inputs (shared with benchmarks/fill_ab.py)
# ---------------------------------------------------------------------------


def stream_kernel_vs_twin(pairs, dirs_mode, np_slots=8, lpt=None,
                          twin=True, reps=3, compat=True):
    """The streamed fill on the runner's device-side layout, CUDA kernel
    and lax twin: finals and dirs words compared bit for bit."""
    import jax
    import jax.numpy as jnp

    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu.ops import nw_affine_stream as ns
    from sequencealigning_tpu.parallel.runner import _mk_streams

    batch = trim_for_stream(pack_batch(pairs, batch_size=len(pairs)))
    B, L1 = batch.query.shape
    L2 = batch.db.shape[1]
    plan = ns.plan_stream(B, L1, L2, np_slots=np_slots)
    R, NP = plan.n_rows, plan.np_slots
    q = np.zeros((R * NP, L1), np.int32)
    d = np.zeros((R * NP, L2), np.int32)
    q[:B], d[:B] = batch.query, batch.db
    ql = np.ones(R * NP, np.int32)
    dl = np.ones(R * NP, np.int32)
    ql[:B], dl[:B] = batch.query_len, batch.db_len
    args = (
        jnp.asarray(q.reshape(R, NP, L1)), jnp.asarray(d.reshape(R, NP, L2)),
        jnp.asarray((ql + dl).reshape(R, NP).T),
        jnp.asarray(dl.reshape(R, NP).T),
    )
    sch = ScoringScheme()
    cuda_fn = jax.jit(lambda a, b, c, e: ns.gotoh_fill_stream_cuda(
        a, b, c, e, plan, sch, compat, False, dirs_mode, lpt=lpt))

    @jax.jit
    def lax_fn(a, b, c, e):
        qs, ds = _mk_streams(a, b, plan)
        return ns.gotoh_fill_stream_lax(
            qs, ds, c, e, plan, sch, compat, False, dirs_mode)

    out_c, t_c = best_time(lambda: cuda_fn(*args), reps)
    rec = dict(
        pairs=B, length=L2, np_slots=NP, rows=R, dirs=str(dirs_mode),
        compat=compat,
        lpt=lpt or ns.stream_lanes_per_thread(plan.p), cuda_s=t_c,
        cells=float(np.sum(batch.query_len.astype(np.int64) *
                           batch.db_len)),
    )
    if twin:
        out_l, rec["lax_s"] = best_time(lambda: lax_fn(*args), 1)
        rec["finals_equal"] = all(
            bool(jnp.array_equal(x, y)) for x, y in zip(out_c[0], out_l[0])
        )
        rec["dirs_equal"] = (out_c[1] is None and out_l[1] is None) or bool(
            jnp.array_equal(out_c[1], out_l[1]))
    return rec


def banded_kernel_vs_twin(pairs, band, want_dirs, twin=True, reps=3,
                          compat=True, model="ref"):
    """nw_banded_diag_batch with backend cuda and lax on one batch."""
    import jax.numpy as jnp

    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch

    batch = pack_batch(pairs, batch_size=len(pairs))
    res, times = {}, {}
    for eng in ("cuda", "lax") if twin else ("cuda",):
        def run(eng=eng):
            r = nw_banded_diag_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                band=band, compat=compat, wildcard=True,
                with_dirs=want_dirs, backend=eng, model=model,
            )
            return r.finals, r.dirs
        res[eng], times[eng] = best_time(run, reps if eng == "cuda" else 1)
    rec = dict(pairs=len(pairs), length=batch.db.shape[1], band=band,
               dirs=str(want_dirs), compat=compat, model=model,
               cuda_s=times["cuda"])
    if twin:
        rec["lax_s"] = times["lax"]
        rec["finals_equal"] = bool(
            jnp.array_equal(res["cuda"][0], res["lax"][0]))
        rec["dirs_equal"] = res["cuda"][1] is None or bool(
            jnp.array_equal(res["cuda"][1], res["lax"][1]))
    return rec


def best_time(fn, reps):
    """(result, best warm seconds) of fn(), each run ended on the device."""
    out = ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


def first_only_via_runner(runner, pairs):
    """GotohAligner(first_only=True)'s path on a given runner: the fused
    fill + device walk dispatch, then the host decode.  Returns
    [(score, aligned_query, aligned_db)]."""
    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream

    batch = trim_for_stream(
        pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
    )
    args, plan, Bp, has_n = runner._stream_args(batch)
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    finals, handles = runner.fill_walk_from_stream_args(
        args, plan, Bp, has_n, s1, s2)
    tb = runner.device_walk_fast4_finish(handles, np.asarray(finals), s1, s2)
    return [(r[0], r[1][0][0], r[1][0][1]) for r in tb]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    if jax.default_backend() != "gpu":
        print("chip_smoke: JAX found no GPU", file=sys.stderr)
        sys.exit(2)
    import sequencealigning_tpu

    check(
        Path(sequencealigning_tpu.__file__).resolve().parents[1] == HERE,
        "the package imported is not the one beside chip_smoke.py",
    )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    from sequencealigning_tpu import cuda

    t0 = time.perf_counter()
    cuda.ensure_registered()
    dev = jax.devices()[0]
    say("device", kind=dev.device_kind, count=len(jax.devices()),
        kernel_build_and_load_s=time.perf_counter() - t0,
        nvcc_s=cuda.build_seconds)
    return card


def phase_gotoh(rng, pool):
    """Configs 2 + headline: 4096 x 2 kb first-path through GotohAligner
    (runner fused fill + device walk), then 64 x 2 kb co-optimal."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.models.gotoh import GotohAligner
    from sequencealigning_tpu.utils.synth import mutated_pairs

    n, length = SIZES["gotoh"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    sample = [int(i) for i in rng.choice(n, min(32, n), replace=False)]
    oracle = {i: pool.submit(_oracle_job, ("gotoh_score", *pairs[i]))
              for i in sample}
    recs = _records(pairs)
    al = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH,
                                  first_only=True))
    al.align_batch(recs)  # compile + warm
    t0 = time.perf_counter()
    res = al.align_batch(recs)
    dt = time.perf_counter() - t0
    cells = float(sum(len(q) * len(d) for q, d in pairs))
    check(all(r.ok and r.cigar is not None for r in res), "gotoh: errors")
    n_resc = _rescored(res)
    check(n_resc == n, f"gotoh: {n - n_resc} CIGARs do not rescore")
    bad = [i for i in sample if oracle[i].result() != res[i].score]
    check(not bad, f"gotoh: oracle score mismatch at pairs {bad}")
    sub = pairs[: SIZES["twin_sub"][0]]
    for m, compat in STREAM_VARIANTS:
        t = stream_kernel_vs_twin(sub, m, reps=1, compat=compat)
        check(t["finals_equal"] and t["dirs_equal"],
              f"gotoh: kernel != lax twin ({t['dirs']}, compat={compat})")
    say("gotoh_first_only", pairs=n, length=length, wall_s=dt,
        pairs_per_s=n / dt, gcups=cells / dt / 1e9, rescored=n_resc,
        oracle_checked=len(sample),
        twin_bitexact=f"{len(sub)} pairs x {len(STREAM_VARIANTS)} variants")

    # Co-optimal enumeration (config 2 proper): 64 x 2 kb.
    n, length = SIZES["gotoh_full"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    sample = list(range(0, n, 8))
    oracle = {i: pool.submit(_oracle_job, ("gotoh_all", *pairs[i]))
              for i in sample}
    recs = _records(pairs)
    al = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    al.align_batch(recs)
    t0 = time.perf_counter()
    res = al.align_batch(recs)
    dt = time.perf_counter() - t0
    # Compat co-optimal enumeration fails where the reference's own
    # traceback would (a co-optimal path reaching a boundary chain); every
    # such pair must fail in the oracle too.
    errs = [i for i, r in enumerate(res) if not r.ok]
    for i in errs:
        oracle.setdefault(i, pool.submit(_oracle_job,
                                         ("gotoh_all", *pairs[i])))
    n_resc = _rescored(res)
    check(n_resc == n - len(errs), "gotoh_full: CIGARs do not rescore")
    for i, fut in oracle.items():
        got = fut.result()
        if got[0] == "error":
            check(not res[i].ok, f"gotoh_full: oracle fails, pair {i} not")
            continue
        score, alns = got
        check(res[i].ok and score == res[i].score, f"gotoh_full: score {i}")
        check([tuple(a) for a in res[i].alignments] ==
              [tuple(a) for a in alns], f"gotoh_full: alignment list {i}")
    say("gotoh_full", pairs=n, length=length, wall_s=dt, pairs_per_s=n / dt,
        rescored=n_resc, reference_errors=len(errs),
        oracle_checked=len(oracle))


def phase_banded(rng):
    """Config 4: 1024 x 5 kb, band 128, through BandedAligner (fast4 +
    device walk); both banded walk settings timed."""
    import jax

    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.models.banded import BandedAligner
    from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch
    from sequencealigning_tpu.ops.traceback_device import (
        banded_diag_align_device,
    )
    from sequencealigning_tpu.utils.synth import mutated_pairs

    n, length = SIZES["banded"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    recs = _records(pairs)
    al = BandedAligner(AlignConfig(algo=Algo.BANDED, band=128,
                                   first_only=True))
    al.align_batch(recs)
    t0 = time.perf_counter()
    res = al.align_batch(recs)
    dt = time.perf_counter() - t0
    check(all(r.ok for r in res), "banded: errors")
    n_resc = _rescored(res)
    check(n_resc == n, f"banded: {n - n_resc} CIGARs do not rescore")
    for m, compat, model in BANDED_VARIANTS:
        tw = banded_kernel_vs_twin(pairs[:64], 128, m, reps=1,
                                   compat=compat, model=model)
        check(tw["finals_equal"] and tw["dirs_equal"],
              f"banded: kernel != twin ({m}, compat={compat}, {model})")

    # Walk setting A/B on one fill (same outputs, two scan shapes).
    batch = pack_batch(pairs, batch_size=n)
    fill = nw_banded_diag_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=128,
        wildcard=True, with_dirs="fast4")
    finals = np.asarray(fill.finals)
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    walks = {}
    for setting in ((4, 2), (2, 1)):
        run = lambda: banded_diag_align_device(  # noqa: E731
            fill.dirs, finals, s1, s2, fill.k_lo_even,
            walk_setting=setting)
        run()
        t1 = time.perf_counter()
        walks[setting] = (run(), time.perf_counter() - t1)
    check(walks[(4, 2)][0][0] == walks[(2, 1)][0][0],
          "banded: walk settings disagree")
    say("banded", pairs=n, length=length, band=128, wall_s=dt,
        pairs_per_s=n / dt, rescored=n_resc,
        twin_bitexact=f"64 pairs x {len(BANDED_VARIANTS)} variants",
        walk_4x2_s=walks[(4, 2)][1], walk_2x1_s=walks[(2, 1)][1],
        peak_gb=peak_gb())


def _wfa_leg(pairs, tag, max_band=None, **cfg):
    """One WFA engine on ``pairs`` (warm, timed) against the native host
    engine under the same penalties: every score equal, every alignment
    rescoring to it under the penalty scheme.  max_band caps the banded
    route's band escalation (WfaAligner.wfa_banded_max_band)."""
    from sequencealigning_tpu.config import AlignConfig, Algo, ScoringScheme
    from sequencealigning_tpu.models.wfa import WfaAligner
    from sequencealigning_tpu.utils.rescore import affine_rescore

    recs = _records(pairs)
    al = WfaAligner(AlignConfig(algo=Algo.WFA, compat=False, **cfg))
    if max_band is not None:
        al.wfa_banded_max_band = max_band
    cfg.pop("wfa_engine", None)
    native = WfaAligner(AlignConfig(algo=Algo.WFA, compat=False,
                                    wfa_engine="native", **cfg))
    al.align_batch(recs)
    t0 = time.perf_counter()
    res = al.align_batch(recs)
    dt = time.perf_counter() - t0
    ref = native.align_batch(recs)
    n = len(pairs)
    check(all(r.ok for r in res), f"{tag}: errors")
    bad = [i for i in range(n) if res[i].score != ref[i].score]
    check(not bad, f"{tag}: != native at {bad[:8]}")
    pen = al.config.wfa_penalties  # min-penalty: score = -rescore
    sch = ScoringScheme(match_=0, mismatch=-pen.mismatch,
                        gap_open=-pen.gap_open, gap_extend=-pen.gap_extend)
    n_resc = sum(
        1 for r in res
        if -affine_rescore(r.aligned_query, r.aligned_db, sch, compat=False)
        == r.score
    )
    check(n_resc == n, f"{tag}: {n - n_resc} alignments do not rescore")
    return dt


def phase_wfa(rng):
    """Config 3: 128 x 10 kb at 0.5% divergence, textbook.  The auto route
    (native host engine at this divergence), then the banded device route
    on the same pairs (CUDA banded fill, reference model), then an
    out-of-regime penalty scheme on the banded route (the kernel's
    any-state-open "std" model), and that route with its band escalation
    capped at 0, so every pair takes the one full-width round (wider than
    the CUDA kernel's lanes: the lax twin, backend.CUDA_MAX_LANES).  Every
    score equals the native engine's under the same penalties."""
    from sequencealigning_tpu.config import WfaPenalties
    from sequencealigning_tpu.utils.synth import mutated_pairs

    n, length = SIZES["wfa"]
    pairs = mutated_pairs(rng, n, length, 0.005)
    dt = _wfa_leg(pairs, "wfa")
    dt_b = _wfa_leg(pairs, "wfa_banded", wfa_engine="banded")
    std = WfaPenalties(mismatch=8, gap_open=6, gap_extend=2)
    n_s, _ = SIZES["wfa_std"]
    dt_s = _wfa_leg(pairs[:n_s], "wfa_std", wfa_engine="banded",
                    wfa_penalties=std)
    n_w, length_w = SIZES["wfa_wide"]
    wide = mutated_pairs(rng, n_w, length_w, 0.01)
    dt_w = _wfa_leg(wide, "wfa_wide", max_band=0, wfa_engine="banded",
                    wfa_penalties=std)
    say("wfa", pairs=n, length=length, auto_wall_s=dt,
        auto_pairs_per_s=n / dt, banded_wall_s=dt_b,
        banded_pairs_per_s=n / dt_b, std_pairs=n_s, std_wall_s=dt_s,
        full_width_pairs=n_w, full_width_twin_wall_s=dt_w,
        equal_native=True, peak_gb=peak_gb())


def phase_wide(rng):
    """Gotoh pairs past the CUDA streamed fill's 4096 lanes (5 kb): the
    streamed route on its lax twin (backend.CUDA_MAX_LANES), co-optimal
    and first-path, checked against the exact tiled fill and by
    rescoring."""
    from sequencealigning_tpu import backend
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.models.gotoh import GotohAligner
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_batch,
    )
    from sequencealigning_tpu.utils.rescore import affine_rescore
    from sequencealigning_tpu.utils.synth import mutated_pairs

    out = {}
    for tag, first_only in (("wide_full", False), ("wide_first", True)):
        n, length = SIZES[tag]
        pairs = mutated_pairs(rng, n, length, 0.005)
        check(backend.engine("stream", "auto", length + 128) == "lax",
              f"{tag}: not past the kernel's lanes")
        recs = _records(pairs)
        al = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH,
                                      first_only=first_only))
        al.align_batch(recs)
        t0 = time.perf_counter()
        res = al.align_batch(recs)
        dt = time.perf_counter() - t0
        b = pack_batch(pairs, batch_size=n)
        exact = np.asarray(nw_affine_tiled_batch(
            b.query, b.db, b.query_len, b.db_len)).max(axis=1)
        ok = [i for i, r in enumerate(res) if r.ok]
        check(all(res[i].score == exact[i] for i in ok),
              f"{tag}: score != tiled fill")
        n_alns = 0
        for i in ok:
            for a1, a2 in res[i].alignments:
                check(affine_rescore(a1, a2) == exact[i],
                      f"{tag}: alignment of pair {i} does not rescore")
                n_alns += 1
        # Compat co-optimal enumeration fails only where the reference's
        # own traceback would; first-path never does.
        check(len(ok) == n or not first_only, f"{tag}: errors")
        out[tag] = (n, dt, len(ok), n_alns)
    say("wide", length=SIZES["wide_full"][1], engine="lax",
        full_pairs=out["wide_full"][0], full_wall_s=out["wide_full"][1],
        full_ok=out["wide_full"][2], full_alignments=out["wide_full"][3],
        first_pairs=out["wide_first"][0], first_wall_s=out["wide_first"][1],
        first_rescored=out["wide_first"][3])


def phase_stream(rng, pool, runner=None, n_batches=16, tag="stream"):
    """Config 5 shape: stream_align over n_batches of 2048 x 1 kb, scores
    then cigars.  Returns (scores, alignments) for cross-mesh checks."""
    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.parallel.streaming import stream_align
    from sequencealigning_tpu.utils.rescore import affine_rescore
    from sequencealigning_tpu.utils.synth import mutated_pairs

    bs, length = SIZES["stream"]
    runner = runner or DataParallelRunner()
    pairs = mutated_pairs(rng, bs * n_batches, length, 0.01)
    sample = [int(i) for i in rng.choice(len(pairs), 16, replace=False)]
    oracle = ({i: pool.submit(_oracle_job, ("gotoh_score", *pairs[i]))
               for i in sample} if pool else {})
    scores = np.zeros(len(pairs), np.int64)
    alns = [None] * len(pairs)

    def on_result(bi, fin):
        fin = np.asarray(fin)
        scores[bi * bs: bi * bs + len(fin)] = fin.max(axis=1)

    def on_alignments(bi, out):
        for j, r in enumerate(out):
            alns[bi * bs + j] = r

    stream_align(pairs[: 2 * bs], runner=runner, batch_size=bs)  # warm
    stream_align(pairs[: 2 * bs], runner=runner, batch_size=bs,
                 cigars=True)
    t0 = time.perf_counter()
    n = stream_align(pairs, runner=runner, batch_size=bs,
                     on_result=on_result)
    dt_s = time.perf_counter() - t0
    check(n == len(pairs), f"{tag}: scores streamed {n}")
    t0 = time.perf_counter()
    n = stream_align(pairs, runner=runner, batch_size=bs, cigars=True,
                     on_alignments=on_alignments)
    dt_c = time.perf_counter() - t0
    check(n == len(pairs), f"{tag}: cigars streamed {n}")
    check(all(isinstance(a, tuple) for a in alns), f"{tag}: cigar errors")
    check(all(a[0] == s for a, s in zip(alns, scores)),
          f"{tag}: cigars-mode scores != scores-mode")
    resc = rng.choice(len(pairs), min(512, len(pairs)), replace=False)
    check(all(affine_rescore(*alns[i][1][0]) == alns[i][0] for i in resc),
          f"{tag}: sampled CIGARs do not rescore")
    bad = [i for i, f in oracle.items() if f.result() != scores[i]]
    check(not bad, f"{tag}: oracle mismatch at {bad}")
    say(tag, batches=n_batches, batch=bs, length=length,
        devices=runner.n_devices, scores_wall_s=dt_s,
        scores_pairs_per_s=len(pairs) / dt_s, cigars_wall_s=dt_c,
        cigars_pairs_per_s=len(pairs) / dt_c, rescored_sample=len(resc),
        oracle_checked=len(oracle))
    return scores, [(a[0], a[1][0]) for a in alns]


def phase_linear(rng):
    """Config 1: one 1 kb pair through nw-linear vs oracle_linear."""
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.models.linear import LinearNWAligner
    from sequencealigning_tpu.ops import oracle_linear
    from sequencealigning_tpu.utils.cigar import cigar_from_pair
    from sequencealigning_tpu.utils.synth import mutated_pairs

    s1, s2 = mutated_pairs(rng, 1, SIZES["linear"][1], 0.01)[0]
    al = LinearNWAligner(AlignConfig(algo=Algo.NW_LINEAR))
    al.align_batch(_records([(s1, s2)]))
    t0 = time.perf_counter()
    r = al.align_batch(_records([(s1, s2)]))[0]
    dt = time.perf_counter() - t0
    exp = oracle_linear.linear_score(s1, s2)
    a1, a2, _, _ = oracle_linear.linear_traceback(s1, s2, max_hits=1)[0]
    check(r.ok and r.score == exp, f"linear: score {r.score} != {exp}")
    check(str(r.cigar) == str(cigar_from_pair(a1, a2)), "linear: CIGAR")
    say("linear", length=len(s2), wall_s=dt, score=r.score, cigar_equal=True)


def phase_cli(rng):
    """cli.main in-process: 8 x 8 records of 2 kb, first-only NW, JSONL
    output compared with the API on the same records."""
    from sequencealigning_tpu import cli
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import parse_fasta
    from sequencealigning_tpu.models.gotoh import GotohAligner
    from sequencealigning_tpu.utils.synth import mutated_pairs

    WORK.mkdir(parents=True, exist_ok=True)
    n, length = SIZES["cli"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    qf, df, out = WORK / "q.fa", WORK / "d.fa", WORK / "out.jsonl"
    qf.write_text("".join(f">q{i}\n{q.decode()}\n"
                          for i, (q, _) in enumerate(pairs)))
    df.write_text("".join(f">d{i}\n{d.decode()}\n"
                          for i, (_, d) in enumerate(pairs)))
    argv = ["-q", str(qf), "-d", str(df), "-a", "needleman-wunsch",
            "--first-only", "-o", str(out)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli: exit {rc}")
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    check(len(lines) == n * n, f"cli: {len(lines)} lines")
    al = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH,
                                  first_only=True))
    api = list(al.align_all_pairs(parse_fasta(str(qf)),
                                  parse_fasta(str(df))))
    check(all(a.score == ln["score"] and str(a.cigar) == ln["cigar"]
              for a, ln in zip(api, lines)), "cli: output != API")
    say("cli", pairs=n * n, length=length, wall_s=dt, jsonl_lines=len(lines),
        equal_api=True)


def phase_ab(rng):
    """Each kept kernel against its lax twin end to end at its phase's
    width: the streamed fill through the runner's fused fill + walk +
    decode (1024 x 2 kb: the twin's fast4 byte stack at 4096 pairs would
    not fit the card), the banded fill + device walk at 1024 x 5 kb."""
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch
    from sequencealigning_tpu.ops.traceback_device import (
        banded_diag_device_tbs,
    )
    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.utils.synth import mutated_pairs

    n, length = SIZES["ab_stream"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    out, t = {}, {}
    for eng in ("cuda", "lax"):
        runner = DataParallelRunner(backend=eng)
        first_only_via_runner(runner, pairs)
        t0 = time.perf_counter()
        out[eng] = first_only_via_runner(runner, pairs)
        t[eng] = time.perf_counter() - t0
    check(out["cuda"] == out["lax"], "ab: stream kernel != twin end to end")
    say("ab_stream", pairs=n, length=length, cuda_s=t["cuda"],
        lax_s=t["lax"], speedup=t["lax"] / t["cuda"], identical=True)

    n, length = SIZES["ab_banded"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    batch = pack_batch(pairs, batch_size=len(pairs))
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    for eng in ("cuda", "lax"):
        def run(eng=eng):
            r = nw_banded_diag_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                band=128, wildcard=True, with_dirs="fast4", backend=eng)
            return banded_diag_device_tbs(
                r.dirs, np.asarray(r.finals), s1, s2, r.k_lo_even)
        run()
        t0 = time.perf_counter()
        out[eng] = run()
        t[eng] = time.perf_counter() - t0
    check(out["cuda"] == out["lax"], "ab: banded kernel != twin end to end")
    say("ab_banded", pairs=n, length=length, band=128, cuda_s=t["cuda"],
        lax_s=t["lax"], speedup=t["lax"] / t["cuda"], identical=True)


def four_cards(rng):
    """--four: the data-parallel runner (shard_map + all_gather),
    stream_align over all cards and sequence-parallel ppermute, each
    compared with one card in the same process."""
    import jax

    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.ops.nw_affine_tiled import (
        nw_affine_tiled_batch,
    )
    from sequencealigning_tpu.parallel.mesh import make_mesh
    from sequencealigning_tpu.parallel.runner import DataParallelRunner
    from sequencealigning_tpu.parallel.seqpar import seqpar_fill
    from sequencealigning_tpu.utils.synth import mutated_pairs

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    r4 = DataParallelRunner(mesh=make_mesh(devices=devs))
    r1 = DataParallelRunner(mesh=make_mesh(devices=devs[:1]))

    n, length = SIZES["four"]
    pairs = mutated_pairs(rng, n, length, 0.01)
    out, t = {}, {}
    for name, r in (("4", r4), ("1", r1)):
        first_only_via_runner(r, pairs)
        t0 = time.perf_counter()
        out[name] = first_only_via_runner(r, pairs)
        t[name] = time.perf_counter() - t0
    check(out["4"] == out["1"], "four: fill+walk differs from one card")
    say("four_fill_walk", pairs=n, length=length, cards4_s=t["4"],
        cards1_s=t["1"], scaling=t["1"] / t["4"], identical=True)

    seed = int(rng.integers(1 << 30))
    s4, a4 = phase_stream(np.random.default_rng(seed), None, runner=r4,
                          n_batches=8, tag="four_stream")
    s1_, a1 = phase_stream(np.random.default_rng(seed), None, runner=r1,
                           n_batches=8, tag="one_stream")
    check(np.array_equal(s4, s1_) and a4 == a1,
          "four: stream_align differs from one card")

    q, d = mutated_pairs(rng, 1, SIZES["seqpar"][1], 0.01)[0]
    b = pack_batch([(q, d)], batch_size=1)
    t0 = time.perf_counter()
    sp = seqpar_fill(b.query, b.db, b.query_len, b.db_len,
                     mesh=make_mesh(devices=devs))
    t_sp = time.perf_counter() - t0
    with jax.default_device(devs[0]):
        t0 = time.perf_counter()
        tl = nw_affine_tiled_batch(b.query, b.db, b.query_len, b.db_len)
        t_tl = time.perf_counter() - t0
    check(np.array_equal(np.asarray(sp), np.asarray(tl)),
          "four: seqpar finals != one-card tiled fill")
    say("four_seqpar", length=len(d), cards4_s=t_sp, cards1_tiled_s=t_tl,
        finals=np.asarray(sp)[0].tolist(), identical=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    args = ap.parse_args(argv)

    card = phase_device()
    import jax

    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()
    if args.four:
        four_cards(rng)
    else:
        ctx = multiprocessing.get_context("spawn")
        workers = max(2, min(12, (os.cpu_count() or 4) - 2))
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            phase_gotoh(rng, pool)
            phase_banded(rng)
            phase_wfa(rng)
            phase_wide(rng)
            phase_stream(rng, pool)
            phase_linear(rng)
            phase_cli(rng)
            phase_ab(rng)
    dev = jax.devices()[0]
    say("done", wall_s=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
