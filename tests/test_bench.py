"""bench.py refuses to measure without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_bench_fails_without_gpu():
    """On the CPU backend: non-zero exit and no metric line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    res = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"metric"' not in res.stdout
    assert "no GPU" in res.stderr
