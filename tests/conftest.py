"""Test environment: force an 8-device virtual CPU mesh.

Multi-device sharding is validated without real hardware by asking XLA's
host platform for 8 fake devices.  The platform is forced via jax.config
as well as JAX_PLATFORMS.  Must run before any test imports jax-backed
modules.

Tests of the CUDA fills carry the ``gpu`` marker and need a GPU: they skip
here (the ``gpu_device`` fixture decides at run time, never at import) and
run on the card with ``JAX_PLATFORMS=cuda pytest tests/ -m gpu``, which
leaves out the CPU forcing below.
"""

import os
import sys

import pytest

_ON_GPU = os.environ.get("JAX_PLATFORMS", "") in ("cuda", "gpu")
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# The cli enables the framework's own compile-cache setup on import; keep
# that OFF under pytest (tests control the cache themselves below).
os.environ["SEQALIGN_NO_COMPILE_CACHE"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if not _ON_GPU and "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# ---------------------------------------------------------------------------
# Persistent compile cache for the suite, WITHOUT the zstandard writer.
#
# Round 4 hit a repeatable segfault inside jax's cache write path
# (compilation_cache.put_executable_and_time -> zstandard compress) and
# disabled the cache entirely under pytest.  jax falls back to stdlib
# zlib when the `zstandard` module is unavailable, so blocking the import
# BEFORE jax loads gives a safe persistent cache: warm suite reruns load
# executables from disk instead of recompiling every module (the
# module-boundary clear_caches() guard below drops only the in-memory
# caches).  Opt out with SEQALIGN_TEST_CACHE=0 (e.g. the segfault-repro
# run, which must reproduce round-4 conditions exactly).
_use_cache = os.environ.get("SEQALIGN_TEST_CACHE", "1") != "0"
if _use_cache:
    sys.modules["zstandard"] = None  # import zstandard -> ImportError

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
if _use_cache:
    _cache_dir = os.environ.get(
        "SEQALIGN_TEST_CACHE_DIR",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_test_cache",
        ),
    )
    os.makedirs(_cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
if not _ON_GPU:
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu_device():
    """The GPU a ``gpu``-marked test runs on; skips where there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (CUDA fills have no CPU mode)")
    return jax.devices()[0]


# ---------------------------------------------------------------------------
# Compiler-state guard: a ~300-test single-process run accumulates enough
# XLA CPU backend state that `backend_compile_and_load` segfaulted three
# times at the same late-suite WFA compile (2026-08-20) while every
# sub-suite passes in isolation (RSS stayed < 4 GB, so it is compiler
# state, not memory pressure).  Dropping jax's in-memory caches at every
# MODULE boundary keeps each module's compiles in a near-fresh process
# regime; cross-module executable reuse now comes from the persistent
# disk cache above, so the cost is small.  SEQALIGN_NO_COMPILER_GUARD=1
# disables the guard (the repro configuration).

try:  # deep LLVM passes near the thread stack limit are a known SIGSEGV
    import resource

    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    if _soft != resource.RLIM_INFINITY and (
        _hard == resource.RLIM_INFINITY or _hard > _soft
    ):
        resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except Exception:
    pass

_guard = os.environ.get("SEQALIGN_NO_COMPILER_GUARD", "") != "1"


def pytest_runtest_teardown(item, nextitem):
    if not _guard:
        return
    if nextitem is None or item.module is not getattr(
        nextitem, "module", None
    ):
        import gc

        jax.clear_caches()
        gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: runs a CUDA fill on an NVIDIA GPU; skipped without one "
        "(run on the card: JAX_PLATFORMS=cuda pytest tests/ -m gpu)",
    )
    config.addinivalue_line(
        "markers",
        "tier2: multi-minute fuzz/parity sweeps (full coverage tier). "
        "The quick loop is `pytest tests/ -m 'not tier2'`; CI and the "
        "pre-commit gate run everything.",
    )
