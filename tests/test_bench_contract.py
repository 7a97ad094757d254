"""bench.py and chip_smoke.py measure on a GPU or not at all.

Neither falls back to the CPU: run where JAX finds no GPU, each exits
non-zero and prints no result (no JSON line, no ``"ok": true``), so a
missing card can never read as a measurement.  Runs the real scripts in
subprocesses on the forced-CPU path.
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        timeout=300, env=env, cwd=cwd,
    )


def _json_lines(stdout):
    out = []
    for ln in stdout.splitlines():
        try:
            out.append(json.loads(ln))
        except ValueError:
            pass
    return out


def test_bench_emits_one_json_line_on_cpu():
    """Without a GPU bench.py refuses: non-zero exit, no JSON result."""
    out = _run(os.path.join(REPO, "bench.py"), REPO)
    assert out.returncode != 0
    assert _json_lines(out.stdout) == []
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_gpu():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert _json_lines(out.stdout) == []


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it cannot import the package, so it fails the same way."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
