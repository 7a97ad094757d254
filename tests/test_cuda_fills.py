"""The CUDA fills: engine choice, wrapper shapes and limits, build paths.

The kernels themselves run only on an NVIDIA GPU (``gpu``-marked tests,
mirrored by chip_smoke.py's phases); everything around them -- which
engine a platform gets, the FFI results' shapes and dtypes, the lane
limits, where the library and the compile cache live -- is tested here
on the CPU.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sequencealigning_tpu import backend, cuda
from sequencealigning_tpu.config import ScoringScheme
from sequencealigning_tpu.ops import nw_affine_stream as ns
from sequencealigning_tpu.ops import nw_banded_diag as nd
from sequencealigning_tpu.utils import compilecache
from sequencealigning_tpu.utils.synth import mutated_pairs

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "sequencealigning_tpu"


@pytest.fixture
def on_platform(monkeypatch):
    """Pretend JAX's default platform is the given one."""

    def set_(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_


# ---------------------------------------------------------------------------
# Engine choice (sequencealigning_tpu.backend)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kernel,lanes",
    [("stream", 0), ("stream", 49_152), ("banded_diag", 0),
     ("banded_diag", 6144)],
)
def test_cpu_maps_every_fill_to_lax(kernel, lanes):
    assert backend.platform() == "cpu"
    assert backend.engine(kernel, "auto", lanes) == "lax"
    assert backend.engine(kernel, "lax", lanes) == "lax"


@pytest.mark.parametrize(
    "kernel,lanes,want",
    [("stream", 0, "cuda"), ("stream", 4096, "cuda"), ("stream", 4224, "lax"),
     ("banded_diag", 6144, "cuda"), ("banded_diag", 6272, "lax")],
)
def test_gpu_maps_kept_kernels_to_cuda(on_platform, kernel, lanes, want):
    """On a GPU "auto" picks the CUDA kernel for a row it holds and the
    lax twin for a wider one; "cuda" on a wider row raises."""
    on_platform("gpu")
    assert backend.engine(kernel, "auto", lanes) == want
    if want == "lax":
        with pytest.raises(ValueError, match="exceeds"):
            backend.engine(kernel, "cuda", lanes)
    else:
        assert backend.engine(kernel, "cuda", lanes) == "cuda"


@pytest.mark.parametrize("name", ["tpu", "rocm", "METAL"])
def test_other_platforms_raise(on_platform, name):
    on_platform(name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.engine("stream")


@pytest.mark.parametrize(
    "kernel,choice,why",
    [("tiled", "lax", "no engine choice"), ("stream", "pallas", "unknown"),
     ("banded_diag", "x", "unknown")],
)
def test_unknown_engine_requests_raise(kernel, choice, why):
    """Only the two fills with a CUDA kernel have an engine choice."""
    with pytest.raises(ValueError, match=why):
        backend.engine(kernel, choice)


def test_walk_setting_per_platform(on_platform):
    assert backend.banded_walk_setting() == (2, 1)
    on_platform("gpu")
    assert backend.banded_walk_setting() == (4, 2)


def test_no_tpu_pallas_anywhere():
    """No module imports the TPU Pallas dialect or branches on a TPU."""
    pat = re.compile(
        r"pallas import tpu|pallas\.tpu|pltpu|== \"tpu\"|interpret\s*="
    )
    roots = [PKG, REPO / "benchmarks"]
    files = [REPO / "bench.py", REPO / "chip_smoke.py"]
    for root in roots:
        files += sorted(root.rglob("*.py"))
    hits = [
        f"{f.relative_to(REPO)}:{i + 1}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines())
        if pat.search(line)
    ]
    assert hits == []


# ---------------------------------------------------------------------------
# FFI wrappers: shapes, dtypes, lane limits (jax.eval_shape needs no GPU)
# ---------------------------------------------------------------------------


def _stream_shapes(n_pairs, l1, l2, np_slots, dirs_mode):
    plan = ns.plan_stream(n_pairs, l1, l2, np_slots=np_slots)
    R, NP = plan.n_rows, plan.np_slots
    i32 = jnp.int32
    out = jax.eval_shape(
        lambda a, b, c, d: ns.gotoh_fill_stream_cuda(
            a, b, c, d, plan, ScoringScheme(), True, False, dirs_mode
        ),
        jax.ShapeDtypeStruct((R, NP, l1), i32),
        jax.ShapeDtypeStruct((R, NP, l2), i32),
        jax.ShapeDtypeStruct((NP, R), i32),
        jax.ShapeDtypeStruct((NP, R), i32),
    )
    return plan, out


@pytest.mark.parametrize("dirs_mode", [False, "fast4", "full"])
def test_stream_wrapper_shapes(dirs_mode):
    plan, ((fm, fi, fd), dirs) = _stream_shapes(64, 300, 290, 4, dirs_mode)
    for f in (fm, fi, fd):
        assert f.shape == (plan.np_slots, plan.n_rows)
        assert f.dtype == jnp.int32
    if not dirs_mode:
        assert dirs is None
        return
    per_word = 8 if dirs_mode == "fast4" else 4
    assert dirs.shape == (plan.t_total // per_word, plan.n_rows, plan.p)
    assert dirs.dtype == jnp.uint32


def test_stream_wrapper_padded_plan():
    """A batch that is not a multiple of np_slots * 8 pads to whole rows;
    the wrapper's outputs follow the padded plan (the twin's layout)."""
    plan, ((fm, _, _), dirs) = _stream_shapes(37, 130, 129, 3, "fast4")
    assert plan.n_rows * plan.np_slots >= 37
    assert plan.n_rows % 8 == 0 and plan.p == 256
    assert fm.shape == (3, plan.n_rows)
    assert dirs.shape == (plan.t_total // 8, plan.n_rows, 256)


@pytest.mark.parametrize("p", [128, 384, 2048, 2176, 4096])
def test_stream_lanes_tile_the_row(p):
    lpt = ns.stream_lanes_per_thread(p)
    assert ns.stream_lanes_valid(p, lpt)
    assert (p // lpt) % 32 == 0 and p // lpt <= 1024


def test_stream_lane_limit():
    with pytest.raises(ValueError, match="lanes"):
        ns.plan_stream(8, 100, ns.MAX_LANES, np_slots=1)
    ns.plan_stream(8, 100, ns.MAX_LANES - 2, np_slots=1)
    wide = ns.plan_stream(8, 100, backend.CUDA_MAX_LANES["stream"], np_slots=1)
    assert not ns.stream_lanes_valid(wide.p, 4)
    assert not ns.stream_lanes_valid(wide.p, 8)
    plan = ns.plan_stream(8, 100, 300, np_slots=1)
    with pytest.raises(ValueError, match="lanes a thread"):
        jax.eval_shape(
            lambda a: ns.gotoh_fill_stream_cuda(
                a, a, a[:, :, 0].T, a[:, :, 0].T, plan, ScoringScheme(),
                True, False, "fast4", lpt=16,
            ),
            jax.ShapeDtypeStruct((8, 1, 300), jnp.int32),
        )


@pytest.mark.parametrize("want_dirs", [False, "fast4", "full"])
def test_banded_wrapper_shapes(want_dirs):
    B, L, n_iters = 8, 256, 301
    fin, dirs = jax.eval_shape(
        lambda a, b, c, d: nd.banded_diag_fill_cuda(
            a, b, c, d, -130, L, n_iters, 130, ScoringScheme(), True, True,
            want_dirs,
        ),
        jax.ShapeDtypeStruct((B, 300), jnp.int8),
        jax.ShapeDtypeStruct((B, 298), jnp.int8),
        jax.ShapeDtypeStruct((B, 1), jnp.int32),
        jax.ShapeDtypeStruct((B, 1), jnp.int32),
    )
    assert fin.shape == (B, 3) and fin.dtype == jnp.int32
    if not want_dirs:
        assert dirs is None
    else:
        per_word = 8 if want_dirs == "fast4" else 4
        assert dirs.shape == (-(-2 * n_iters // per_word), B, L)
        assert dirs.dtype == jnp.uint32


def test_banded_lane_limit():
    assert nd.banded_lanes_per_thread(256) == 4
    assert nd.banded_lanes_per_thread(4224) == 16
    with pytest.raises(ValueError, match="exceeds"):
        nd.banded_diag_fill_cuda(
            None, None, None, None, 0,
            backend.CUDA_MAX_LANES["banded_diag"] + 128, 10, 0,
            ScoringScheme(), True, False, "fast4",
        )


# ---------------------------------------------------------------------------
# Stream state, model limits, library and cache placement
# ---------------------------------------------------------------------------


def test_stream_state_per_engine(on_platform):
    plan = ns.plan_stream(16, 60, 60)
    sch = ScoringScheme()
    assert ns.resolve_stream_state("auto", sch, plan) == jnp.int16
    assert ns.resolve_stream_state("i16", sch, plan, "lax") == jnp.int16
    with pytest.raises(ValueError, match="int32"):
        ns.resolve_stream_state("i16", sch, plan, "cuda")
    on_platform("gpu")
    assert ns.resolve_stream_state("auto", sch, plan, "cuda") == jnp.int32
    assert ns.resolve_stream_state("auto", sch, plan, "lax") == jnp.int32


def test_model_limits_follow_the_kernel(monkeypatch):
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.models.gotoh import GotohAligner

    al = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH))
    assert al.long_pair_lanes == ns.MAX_LANES
    assert al._dirs_budget() == 9 * 2 ** 30  # fixed on the CPU

    class FakeGpu:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 60 * 2 ** 30}

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    assert al._dirs_budget() == 30 * 2 ** 30


def test_cuda_library_path_is_keyed_and_ignored():
    path = cuda.library_path()
    assert path.parent == cuda.BUILD_DIR == PKG / "cuda" / "build"
    assert path == cuda.library_path()  # deterministic
    assert re.fullmatch(r"libseqalign_cuda-[0-9a-f]{16}\.so", path.name)
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    for src in cuda._SOURCES:
        assert src.parent == PKG / "cuda" and src.exists()


def test_cuda_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the toolkit the build raises; it never falls back."""
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda, "Path", lambda p: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda.build()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.delenv("SEQALIGN_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv(compilecache.ENV, str(tmp_path))
    assert compilecache.cache_dir() == str(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compilecache.enable() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("SEQALIGN_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv(compilecache.ENV, raising=False)
    assert compilecache.default_dir() == str(REPO / ".jax_cache")
    assert compilecache.cache_dir() == compilecache.default_dir()
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compilecache.enable() == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_opt_out(monkeypatch):
    monkeypatch.setenv("SEQALIGN_NO_COMPILE_CACHE", "1")
    assert compilecache.enable() == ""


@pytest.mark.parametrize("length,div", [(300, 0.01), (1000, 0.05)])
def test_synthetic_pairs_are_seeded(length, div):
    a = mutated_pairs(np.random.default_rng(5), 4, length, div)
    b = mutated_pairs(np.random.default_rng(5), 4, length, div)
    assert a == b
    for q, d in a:
        assert len(q) == len(d) == length
        assert set(q) | set(d) <= set(b"ACGT")


# ---------------------------------------------------------------------------
# On the card (chip_smoke.py runs the same comparisons at full size)
# ---------------------------------------------------------------------------


# Every branch of both kernels: dirs mode x compat (x gap-open model).
@pytest.mark.gpu
@pytest.mark.parametrize(
    "dirs_mode,compat",
    [("fast4", True), ("full", True), (False, True), ("fast4", False),
     ("full", False)],
)
def test_stream_kernel_matches_twin_on_gpu(gpu_device, dirs_mode, compat):
    from chip_smoke import stream_kernel_vs_twin

    pairs = mutated_pairs(np.random.default_rng(1), 64, 700)
    rec = stream_kernel_vs_twin(pairs, dirs_mode, np_slots=4, reps=1,
                                compat=compat)
    assert rec["finals_equal"] and rec["dirs_equal"]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dirs_mode,compat,model",
    [("fast4", True, "ref"), ("full", True, "ref"), (False, True, "ref"),
     ("fast4", False, "ref"), ("full", False, "ref"),
     ("fast4", False, "std"), (False, False, "std")],
)
def test_banded_kernel_matches_twin_on_gpu(gpu_device, dirs_mode, compat,
                                           model):
    from chip_smoke import banded_kernel_vs_twin

    pairs = mutated_pairs(np.random.default_rng(2), 16, 3000)
    rec = banded_kernel_vs_twin(pairs, 600, dirs_mode, reps=1,
                                compat=compat, model=model)
    assert rec["finals_equal"] and rec["dirs_equal"]


def test_banded_route_beyond_kernel_width(on_platform, monkeypatch):
    """On a GPU "auto" sends bands wider than the kernel's lanes to the
    lax fill (backend.engine's rule: the WFA std route's full-width
    round); an explicit "cuda" request for such a band raises."""
    from sequencealigning_tpu.io.encode import pack_batch

    on_platform("gpu")
    calls = []
    real = nd._banded_diag_lax
    monkeypatch.setattr(
        nd, "_banded_diag_lax", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    nd._jitted_diag.cache_clear()
    monkeypatch.setitem(backend.CUDA_MAX_LANES, "banded_diag", 128)
    pairs = mutated_pairs(np.random.default_rng(3), 8, 200)
    b = pack_batch(pairs, batch_size=8)
    args = (b.query, b.db, b.query_len, b.db_len)
    try:
        res = nd.nw_banded_diag_batch(*args, band=200, with_dirs=False)
        assert calls and np.asarray(res.finals).shape == (8, 3)
        with pytest.raises(ValueError, match="exceeds"):
            nd.nw_banded_diag_batch(
                *args, band=200, with_dirs=False, backend="cuda"
            )
    finally:
        nd._jitted_diag.cache_clear()


def test_stream_route_beyond_kernel_width(on_platform, monkeypatch):
    """On a GPU "auto" runs a row wider than the CUDA streamed fill holds
    on the lax twin -- in the fill entry and in the runner, per batch --
    and an explicit "cuda" request for it raises."""
    from sequencealigning_tpu.io.encode import pack_batch
    from sequencealigning_tpu.parallel.runner import DataParallelRunner

    on_platform("gpu")
    calls = []
    real = ns.gotoh_fill_stream_lax
    monkeypatch.setattr(
        ns, "gotoh_fill_stream_lax",
        lambda *a, **k: calls.append(1) or real(*a, **k),
    )
    monkeypatch.setitem(backend.CUDA_MAX_LANES, "stream", 128)
    pairs = mutated_pairs(np.random.default_rng(4), 8, 200)
    b = pack_batch(pairs, batch_size=8)
    args = (b.query, b.db, b.query_len, b.db_len)
    res = ns.nw_affine_stream_batch(*args, with_dirs=False, np_slots=1)
    assert calls and res.finals.shape == (8, 3)
    with pytest.raises(ValueError, match="exceeds"):
        ns.nw_affine_stream_batch(*args, with_dirs=False, backend="cuda")
    runner = DataParallelRunner()
    assert runner.engine(ns.plan_stream(8, 200, 200)) == "lax"
    assert runner.engine(ns.plan_stream(8, 100, 100)) == "cuda"
